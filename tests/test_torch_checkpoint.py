"""PyTorch port, checkpoints (``io/checkpoint.py``) against the JAX
package: bitwise save/restore round trips of both families' training
states, pruning, atomic saves, the metadata-only reads the resume guards
use, the refusal of the JAX package's orbax checkpoints, the reference
``.bin`` export byte for byte, and the ``model.json`` sidecar.

Inputs are seeded numpy trees fed to both packages; every comparison is
bitwise unless a test states a tolerance."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import HashGridConfig as JaxHashGridConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.io.checkpoint import export_reference_format as jax_export_reference_format
from nerf_rs_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_rs_tpu.io.weights import load_bundle as jax_load_bundle
from nerf_rs_tpu.io.weights import load_nerf_params as jax_load_nerf_params
from nerf_rs_tpu.models.hashgrid import init_hashgrid_params as jax_init_hashgrid_params
from nerf_rs_tpu.models.mlp import arch_shapes as jax_arch_shapes
from nerf_rs_tpu.models.mlp import init_nerf_params as jax_init_nerf_params
from nerf_rs_tpu.train import create_train_state as jax_create_train_state
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io import checkpoint as ckpt
from nerf_rs_tpu_torch.io.weights import load_nerf_params, save_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import infer_arch
from nerf_rs_tpu_torch.train import train_state_from_numpy
from test_torch_data import write_scene

torch.set_num_threads(1)

SMALL = dict(width=64, v_width=32, depth=4, skip_at=2)
HASH = JaxHashGridConfig(levels=2, table_log2=8, res_max=16)


def np_tree(seed: int, family: str):
    """One network's param tree as numpy f32, drawn by the JAX package's
    initializers from a seed."""
    key = jax.random.key(seed)
    tree = (jax_init_hashgrid_params(key, HASH) if family == "hashgrid"
            else jax_init_nerf_params(key, arch=JaxArchConfig(**SMALL)))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def np_state(family: str, seed: int = 0):
    """(params, mu, nu) numpy trees of both families' training states:
    {"coarse", "fine"} or {"shared"}; the moments seeded numpy draws of
    the params' shapes (nu non-negative)."""
    nets = ("shared",) if family == "hashgrid" else ("coarse", "fine")
    params = {net: np_tree(seed + i, family) for i, net in enumerate(nets)}
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rng.uniform(size=a.shape).astype(np.float32) ** 4,
                                params)
    return params, mu, nu


def flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(value)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def state_trees(state):
    """A port state's params, mu and nu as numpy trees keyed like the
    param trees."""
    params, mu, nu = {}, {}, {}
    for net, module in state.params.items():
        tree = module.tree()
        params[net] = jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)

        def moments(m):
            return {name: ({part: m[f"{name}_{part}"].numpy() for part in value}
                           if isinstance(value, dict) else m[name].numpy())
                    for name, value in tree.items()}

        mu[net], nu[net] = moments(state.mu[net]), moments(state.nu[net])
    return params, mu, nu


@pytest.mark.parametrize("family", ["mlp", "hashgrid"])
def test_round_trip_is_bitwise(tmp_path, family):
    """A state built from seeded numpy trees (step 7, count 5), saved and
    restored on the CPU: params, mu, nu, count and step bitwise equal to
    the trees it was built from."""
    params, mu, nu = np_state(family)
    state = train_state_from_numpy(params, mu, nu, 5, 7, "cpu")
    path = ckpt.save_checkpoint(tmp_path / "ck", state)
    assert path == tmp_path / "ck" / "step_00000007" == ckpt.latest_checkpoint(tmp_path / "ck")
    back = ckpt.restore_checkpoint(path, "cpu")
    assert (back.step, back.count) == (7, 5)
    for got, want in zip(state_trees(back), (params, mu, nu)):
        assert_trees_equal(got, want)
    got_params, step = ckpt.restore_params(path)
    assert step == 7
    assert_trees_equal(got_params, params)
    with np.load(path / "state.npz", allow_pickle=False) as z:
        assert all(z[k].dtype == np.dtype("<f4") for k in z.files)


def test_keep_prunes_to_the_newest(tmp_path):
    """Five saves with keep=3 leave the newest three; a second save of
    the same step replaces it."""
    params, mu, nu = np_state("mlp")
    state = train_state_from_numpy(params, mu, nu, 0, 0, "cpu")
    for step in (1, 2, 3, 4, 5):
        state.step = step
        ckpt.save_checkpoint(tmp_path, state, keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004", "step_00000005"]
    state.count = 11
    ckpt.save_checkpoint(tmp_path, state, keep=3)
    assert ckpt.restore_checkpoint(tmp_path / "step_00000005", "cpu").count == 11
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004", "step_00000005"]


def test_leftover_temporary_directory_is_never_latest(tmp_path, monkeypatch):
    """A save that dies while it writes leaves only a ``.tmp_step_*``
    directory, which latest_checkpoint never returns; the next save of that
    step goes through."""
    params, mu, nu = np_state("mlp")
    state = train_state_from_numpy(params, mu, nu, 0, 3, "cpu")
    ckpt.save_checkpoint(tmp_path, state)
    state.step = 9

    def dies(path, **arrays):
        Path(path).write_bytes(b"truncated")
        raise OSError("killed while writing")

    with monkeypatch.context() as m:
        m.setattr(ckpt.np, "savez", dies)
        with pytest.raises(OSError):
            ckpt.save_checkpoint(tmp_path, state)
    assert (tmp_path / ".tmp_step_00000009").is_dir()
    assert ckpt.latest_checkpoint(tmp_path) == tmp_path / "step_00000003"
    (tmp_path / "step_garbage").mkdir()
    assert ckpt.latest_checkpoint(tmp_path) == tmp_path / "step_00000003"
    assert ckpt.save_checkpoint(tmp_path, state) == tmp_path / "step_00000009"
    assert ckpt.latest_checkpoint(tmp_path) == tmp_path / "step_00000009"
    assert not (tmp_path / ".tmp_step_00000009").exists()
    assert ckpt.latest_checkpoint(tmp_path / "nothing") is None


@pytest.mark.parametrize("arch", [SMALL, dict(width=256, v_width=128, depth=8, skip_at=4),
                                  dict(width=128, v_width=64, depth=3, skip_at=2)])
def test_metadata_shapes_equal_arch_shapes(tmp_path, arch):
    """checkpoint_kernel_shapes, from meta.json alone, equals arch_shapes
    of the arch in both packages; checkpoint_param_keys names the nets."""
    trees = {net: jax.tree_util.tree_map(np.asarray, jax_init_nerf_params(
        jax.random.key(i), arch=JaxArchConfig(**arch))) for i, net in enumerate(("coarse", "fine"))}
    zeros = jax.tree_util.tree_map(np.zeros_like, trees)
    path = ckpt.save_checkpoint(tmp_path, train_state_from_numpy(trees, zeros, zeros, 0, 1, "cpu"))
    (path / "state.npz").unlink()                        # metadata only
    assert ckpt.checkpoint_kernel_shapes(path) == arch_shapes(ArchConfig(**arch)) \
        == jax_arch_shapes(JaxArchConfig(**arch))
    assert ckpt.checkpoint_param_keys(path) == {"coarse", "fine"}


def test_restore_params_trees_are_read_by_infer_arch(tmp_path):
    """restore_params needs no template: its trees give the arch back
    through infer_arch and build networks; a hash-grid checkpoint's keys
    are {"shared"}."""
    params, mu, nu = np_state("mlp")
    path = ckpt.save_checkpoint(tmp_path / "mlp", train_state_from_numpy(params, mu, nu, 0, 2,
                                                                         "cpu"))
    trees, step = ckpt.restore_params(path)
    assert step == 2 and set(trees) == {"coarse", "fine"}
    assert infer_arch(trees["coarse"]) == tuple(SMALL.values())
    NerfMLP(trees["fine"])
    params, mu, nu = np_state("hashgrid")
    path = ckpt.save_checkpoint(tmp_path / "hg", train_state_from_numpy(params, mu, nu, 0, 2,
                                                                        "cpu"))
    assert ckpt.checkpoint_param_keys(path) == {"shared"}
    assert ckpt.restore_params(path)[0]["shared"]["hash_tables"].shape == (2, 256, 2)


def test_orbax_checkpoint_is_refused_with_the_way_through_bin_or_npz(tmp_path):
    """An orbax checkpoint written by the JAX package's save_checkpoint:
    every reader of the port, and the CLI's resume, refuse it with the
    message that names the .bin and .npz formats and the JAX export."""
    cfg = JaxTrainConfig(arch=JaxArchConfig(**SMALL),
                         render=JaxRenderConfig(n_coarse=4, n_fine=4, ray_chunk=16))
    jax_state = jax_create_train_state(jax.random.key(0), cfg)
    path = jax_save_checkpoint(tmp_path / "orbax", jax_state)
    assert ckpt.latest_checkpoint(tmp_path / "orbax") == path
    for read in (ckpt.restore_params, ckpt.checkpoint_param_keys,
                 ckpt.checkpoint_kernel_shapes, lambda p: ckpt.restore_checkpoint(p, "cpu")):
        with pytest.raises(ValueError, match=r"orbax checkpoint of the JAX package") as e:
            read(path)
        assert ".bin" in str(e.value) and ".npz" in str(e.value)
        assert "python -m nerf_rs_tpu export" in str(e.value)
    with pytest.raises(SystemExit) as e:
        cli_main(["train", "--device", "cpu", "--checkpoint-dir", str(tmp_path / "orbax"),
                  *sum((["--" + k.replace("_", "-"), str(v)] for k, v in SMALL.items()), [])])
    assert "orbax checkpoint" in str(e.value.code) and ".npz" in str(e.value.code)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(tmp_path / "missing")


def test_export_is_byte_identical_to_jax_save_nerf_params(tmp_path):
    """export_reference_format (and save_nerf_params of a NerfMLP) writes
    the files, byte for byte, that the JAX package writes for the same
    trees; the JAX loader reads them back bitwise."""
    params = {net: np_tree(i, "mlp") for i, net in enumerate(("coarse", "fine"))}
    ckpt.export_reference_format(tmp_path / "port", params)
    jax_export_reference_format(tmp_path / "jax", params)
    save_nerf_params(tmp_path / "module", NerfMLP(params["coarse"]))
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 2 * (2 * len(arch_shapes(ArchConfig(**SMALL))) + 1)
    assert Path("coarse/shapes.txt") in files
    assert files == sorted(p.relative_to(tmp_path / "port") for p in
                           (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
        if f.parts[0] == "coarse":
            assert (tmp_path / "module" / f.name).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    for net in ("coarse", "fine"):
        assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                                  jax_load_nerf_params(tmp_path / "port" / net)),
                           params[net])
    assert_trees_equal(ckpt.import_reference_format(tmp_path / "jax"), params)


def test_jax_loaders_read_the_ports_export_and_pack(tmp_path, capsys):
    """A checkpoint exported by the port's CLI, and the scene packed by
    it, load in the JAX package bitwise."""
    params, mu, nu = np_state("mlp")
    path = ckpt.save_checkpoint(tmp_path / "ck", train_state_from_numpy(params, mu, nu, 3, 4,
                                                                        "cpu"))
    assert cli_main(["export", "--checkpoint", str(path), "-o", str(tmp_path / "exp")]) == 0
    assert "exported step 4 params" in capsys.readouterr().out
    for net in ("coarse", "fine"):
        got = jax.tree_util.tree_map(np.asarray, jax_load_nerf_params(tmp_path / "exp" / net,
                                                                      device_put=False))
        assert_trees_equal(got, params[net])
    lego = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
    assert cli_main(["pack", "--weights", str(lego), "-o", str(tmp_path / "scene.npz")]) == 0
    trees, golden = jax_load_bundle(tmp_path / "scene.npz", device_put=False)
    assert golden == json.loads((lego / "tf_reference_samples.json").read_text())
    for net in ("coarse", "fine"):
        assert_trees_equal(jax.tree_util.tree_map(np.asarray, trees[net]),
                           load_nerf_params(lego / net))


@pytest.mark.parametrize("model", ["hashgrid", "mlp"])
def test_sidecar_equals_the_jax_cli(tmp_path, monkeypatch, model):
    """``model.json`` written by the port's ``train`` equals, after a JSON
    round trip, the one the JAX ``cmd_train`` writes for the same flags
    (the hash grid's hyper-parameters included)."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    monkeypatch.setenv("NERF_NO_COMPILE_CACHE", "1")
    scene = write_scene(tmp_path)
    flags = ["--data", str(scene), "--steps", "0", "--batch-rays", "16", "--coarse-samples", "4",
             "--fine-samples", "4", "--impl", "xla", "--model", model]
    if model == "hashgrid":
        flags += ["--hash-levels", "2", "--hash-table-log2", "8", "--hash-res-max", "16",
                  "--hash-features", "4", "--hash-extent", "1.5"]
    else:
        flags += sum((["--" + k.replace("_", "-"), str(v)] for k, v in SMALL.items()), [])
    assert jax_cli_main(["train", *flags, "--checkpoint-dir", str(tmp_path / "jax")]) == 0
    assert cli_main(["train", "--device", "cpu", *flags,
                     "--checkpoint-dir", str(tmp_path / "port")]) == 0
    want = json.loads((tmp_path / "jax" / "model.json").read_text())
    got = json.loads((tmp_path / "port" / "model.json").read_text())
    assert got == want and got["model"] == model
    assert ckpt.latest_checkpoint(tmp_path / "port").name == "step_00000000"
