"""PyTorch port, CLI: what ``render`` and ``train`` do with networks and
flags the fused kernels do not serve, against the JAX package's CLI.

The JAX CLI renders and trains any width: weights or students its kernel
cannot serve run ``impl="xla"`` with a note (``nerf_rs_tpu/cli.py``,
``_impl_for_params`` and ``cmd_train``), and ``--impl int8`` is refused
only for the MLP family, whose teacher then renders through the fused
kernel. The port does the same."""

import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.io.golden import load_golden as jax_load_golden
from nerf_rs_tpu.io.weights import save_nerf_params
from nerf_rs_tpu.models.mlp import init_nerf_params
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.io.image import load_ppm

torch.set_num_threads(1)

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
NOTE = "outside the fused kernels' range"
# Wider than the port's kernels serve (256), a multiple of 128 as JAX's
# kernel takes.
WIDE = JaxArchConfig(width=384, v_width=128, depth=2, skip_at=0)


@pytest.fixture(scope="module")
def wide_assets(tmp_path_factory):
    """Width-384 coarse and fine networks in the reference .bin format,
    written by the JAX package, beside the lego camera."""
    root = tmp_path_factory.mktemp("wide")
    for i, net in enumerate(("coarse", "fine")):
        tree = jax.tree_util.tree_map(np.asarray, init_nerf_params(jax.random.key(i), arch=WIDE))
        save_nerf_params(root / net, tree)
    shutil.copy(LEGO / "tf_reference_samples.json", root)
    return root


RENDER = ["render", "--device", "cpu", "--width", "8", "--height", "6", "--coarse-samples", "4",
          "--fine-samples", "4", "--ray-chunk", "16"]


def test_cli_render_unserved_width_runs_xla_with_note(wide_assets, tmp_path, capsys):
    """``--impl pallas`` (the default) on width-384 weights prints the
    note and writes the ``--impl xla`` image, which is JAX's plain render
    of the same weights to a level of the 8-bit image."""
    out = {}
    for impl in ("pallas", "xla"):
        path = tmp_path / f"{impl}.ppm"
        assert cli_main([*RENDER, "--weights", str(wide_assets), "--impl", impl,
                         "-o", str(path)]) == 0
        out[impl] = (path.read_bytes(), capsys.readouterr().out)
    assert NOTE in out["pallas"][1] and NOTE not in out["xla"][1]
    assert "(xla/float32" in out["pallas"][1]
    assert out["pallas"][0] == out["xla"][0]

    from nerf_rs_tpu.io.weights import load_nerf_params as jax_load_nerf_params

    coarse, fine = (jax_load_nerf_params(wide_assets / n) for n in ("coarse", "fine"))
    cam = jax_camera_from_golden(jax_load_golden(wide_assets / "tf_reference_samples.json"))
    want = jax_render_image(coarse, fine, cam, 6, 8, jax.random.key(0),
                            JaxRenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl="xla"))
    got = load_ppm(tmp_path / "pallas.ppm")
    assert np.abs(got - np.clip(np.asarray(want, np.float32), 0, 1)).max() <= 1.0 / 255 + 1e-6


TRAIN = ["train", "--device", "cpu", "--steps", "1", "--batch-rays", "16", "--coarse-samples",
         "4", "--fine-samples", "4", "--log-every", "1"]


def test_cli_train_unserved_width_runs_xla_with_note(capsys):
    """A width-384 student with ``--impl pallas`` trains on the plain MLP
    with the note, where the port's kernels would refuse it."""
    rc = cli_main([*TRAIN, "--width", "384", "--depth", "2", "--skip-at", "0", "--impl", "pallas"])
    assert rc == 0
    out = capsys.readouterr().out
    assert NOTE in out
    assert re.search(r"^step 0: loss [0-9.]+ psnr", out, flags=re.M), out


@pytest.mark.parametrize("impl", ["int8", "int8qat", "pallas"])
def test_cli_train_hashgrid_ignores_impl_and_teacher_runs_fused(impl, monkeypatch, capsys):
    """``train --model hashgrid`` trains the field whatever ``--impl``
    says (``int8`` included); the teacher renders through the fused
    kernel's path for ``int8``, ``int8qat`` and ``pallas``."""
    import nerf_rs_tpu_torch.data as data

    seen = []
    real = data.DistillationDataset

    def spy(teacher, cfg, **kw):
        seen.append(cfg)
        return real(teacher, cfg=cfg, **kw)

    monkeypatch.setattr(data, "DistillationDataset", spy)
    rc = cli_main([*TRAIN, "--model", "hashgrid", "--impl", impl, "--hash-levels", "4",
                   "--hash-table-log2", "12", "--hash-res-max", "64"])
    assert rc == 0
    assert re.search(r"^step 0: loss [0-9.]+ psnr", capsys.readouterr().out, flags=re.M)
    assert [(c.impl, c.model) for c in seen] == [("pallas", "mlp")]
