"""PyTorch port, CLI, against the JAX package's CLI: what ``render`` and
``train`` do with networks and flags the fused kernels do not serve, and
the checkpoint, dataset and front-end slice (``train --data``, resume,
``--init-weights``, SIGTERM, ``render --checkpoint``, ``evaluate``,
``export``, ``pack``, ``info``, ``serve``).

The JAX CLI renders and trains any width: weights or students its kernel
cannot serve run ``impl="xla"`` with a note (``nerf_rs_tpu/cli.py``,
``_impl_for_params`` and ``cmd_train``), and ``--impl int8`` is refused
only for the MLP family, whose teacher then renders through the fused
kernel. The port does the same, with its own envelopes: the forward K1
serves widths up to 512 and depths up to 32, the backward K2 (training)
the same, and the int8 kernels the same, beyond which ``--impl int8``
renders the plain int8 MLP with a note."""

import contextlib
import functools
import io
import json
import re
import shutil
import sys
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
from test_torch_data import write_scene

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LEGO = ROOT / "assets" / "lego_rust"
NOTE = "outside the fused kernels' range"
K2_NOTE = "the fused backward K2 serves width, v_width <= 1024, depth <= 32"
INT8_NOTE = "outside the int8 kernel's range (width, v_width <= 512, depth <= 32)"
# Wider than the narrow kernels serve (256), within K1's envelope (1024), a
# multiple of 128 as JAX's kernel takes.
WIDE = JaxArchConfig(width=384, v_width=128, depth=2, skip_at=0)
# Wider than K1 serves (1024), still a multiple of 128.
WIDER = JaxArchConfig(width=1152, v_width=128, depth=2, skip_at=0)
# Wider than K2 and the int8 kernels serve (512), within K1's envelope.
PAST_512 = JaxArchConfig(width=640, v_width=128, depth=2, skip_at=0)


def _assets(root, arch):
    """Coarse and fine networks of ``arch`` in the reference .bin format,
    written by the JAX package, beside the lego camera."""
    for i, net in enumerate(("coarse", "fine")):
        tree = jax.tree_util.tree_map(np.asarray, init_nerf_params(jax.random.key(i), arch=arch))
        save_nerf_params(root / net, tree)
    shutil.copy(LEGO / "tf_reference_samples.json", root)
    return root


@pytest.fixture(scope="module")
def wide_assets(tmp_path_factory):
    return _assets(tmp_path_factory.mktemp("wide"), WIDE)


@pytest.fixture(scope="module")
def wider_assets(tmp_path_factory):
    return _assets(tmp_path_factory.mktemp("wider"), WIDER)


@pytest.fixture(scope="module")
def past_512_assets(tmp_path_factory):
    return _assets(tmp_path_factory.mktemp("past_512"), PAST_512)


def _jax_frame(assets, impl):
    """JAX's render of the same weights at RENDER's size and samples."""
    from nerf_rs_tpu.io.weights import load_nerf_params as jax_load_nerf_params

    coarse, fine = (jax_load_nerf_params(assets / n) for n in ("coarse", "fine"))
    cam = jax_camera_from_golden(jax_load_golden(assets / "tf_reference_samples.json"))
    want = jax_render_image(coarse, fine, cam, 6, 8, jax.random.key(0),
                            JaxRenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl=impl))
    return np.clip(np.asarray(want, np.float32), 0, 1)


RENDER = ["render", "--device", "cpu", "--width", "8", "--height", "6", "--coarse-samples", "4",
          "--fine-samples", "4", "--ray-chunk", "16"]


def test_cli_render_unserved_width_runs_xla_with_note(wider_assets, tmp_path, capsys):
    """``--impl pallas`` (the default) on width-1152 weights, beyond K1's
    envelope (1024), prints the note and writes the ``--impl xla`` image,
    which is JAX's plain render of the same weights to a level of the
    8-bit image."""
    out = {}
    for impl in ("pallas", "xla"):
        path = tmp_path / f"{impl}.ppm"
        assert cli_main([*RENDER, "--weights", str(wider_assets), "--impl", impl,
                         "-o", str(path)]) == 0
        out[impl] = (path.read_bytes(), capsys.readouterr().out)
    assert NOTE in out["pallas"][1] and NOTE not in out["xla"][1]
    assert "(width, v_width <= 1024, depth <= 32)" in out["pallas"][1]
    assert "(xla/float32" in out["pallas"][1]
    assert out["pallas"][0] == out["xla"][0]
    got = load_ppm(tmp_path / "pallas.ppm")
    assert np.abs(got - _jax_frame(wider_assets, "xla")).max() <= 1.0 / 255 + 1e-6


def test_cli_render_width_384_runs_fused_without_note(wide_assets, tmp_path, capsys):
    """Width-384 weights are within K1's envelope: ``--impl pallas`` keeps
    the fused path (the wide kernels on the card, their plain version
    here), prints no note, and writes JAX's fused render of the same
    weights (its Pallas kernel in interpret mode) to a level of the 8-bit
    image."""
    path = tmp_path / "pallas.ppm"
    assert cli_main([*RENDER, "--weights", str(wide_assets), "--impl", "pallas",
                     "-o", str(path)]) == 0
    text = capsys.readouterr().out
    assert NOTE not in text and "(pallas/float32" in text
    got = load_ppm(path)
    assert np.abs(got - _jax_frame(wide_assets, "pallas")).max() <= 1.0 / 255 + 1e-6


def test_cli_render_int8_beyond_the_int8_kernel_notes_and_matches_jax(tmp_path, capsys):
    """``--impl int8`` on the lego widened to 384 (``chip_smoke.widen_nerf``,
    as phase 29 renders it), beyond the narrow int8 kernel and within the
    wide one's envelope (512, 32): no note, the int8 impl (the wide int8
    kernel on the card, its plain version here), and JAX's ``render --impl
    int8`` frame of the same weights (its int8 path is XLA at every width)
    within one 8-bit level. (Random-init networks miss that level against
    JAX at every width, 128 and 256 included: an activation code that
    rounds the other way moves a near-zero density's samples.) Past the
    envelope the note stays:
    test_cli_render_int8_past_the_int8_envelope_notes."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assets = chip_smoke.write_wide_lego(tmp_path, LEGO, 384, 192, 8)
    path = tmp_path / "int8.ppm"
    assert cli_main([*RENDER, "--weights", str(assets), "--impl", "int8", "-o", str(path)]) == 0
    text = capsys.readouterr().out
    assert "outside the int8 kernel's range" not in text
    assert "(int8/float32" in text and NOTE not in text
    got = load_ppm(path)
    assert np.abs(got - _jax_frame(assets, "int8")).max() <= 1.0 / 255 + 1e-6


def test_cli_render_int8_past_the_int8_envelope_notes(past_512_assets, tmp_path, capsys):
    """``--impl int8`` on width-640 weights, past the int8 kernels' envelope
    (512; within K1's): the note with the envelope's numbers, the int8 impl kept
    (``render.get_mlp_fn`` picks the plain int8 MLP per network on the
    card), no K1 note, and the frame the plain int8 MLP renders."""
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    path = tmp_path / "int8.ppm"
    assert cli_main([*RENDER, "--weights", str(past_512_assets), "--impl", "int8",
                     "-o", str(path)]) == 0
    text = capsys.readouterr().out
    assert INT8_NOTE in text and "(int8/float32" in text and NOTE not in text
    coarse, fine = (NerfMLP(load_nerf_params(past_512_assets / n)) for n in ("coarse", "fine"))
    cam = camera_from_golden(load_golden(past_512_assets / "tf_reference_samples.json"))
    want = render_image(coarse, fine, cam, 6, 8, random.key(0, "cpu"),
                        RenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl="int8"))
    got = load_ppm(path)
    assert got.shape == (6, 8, 3)
    assert np.abs(got - np.clip(want.numpy(), 0, 1)).max() <= 0.5 / 255 + 1e-6


TRAIN = ["train", "--device", "cpu", "--steps", "1", "--batch-rays", "16", "--coarse-samples",
         "4", "--fine-samples", "4", "--log-every", "1"]


def test_cli_train_unserved_width_runs_xla_with_note(capsys):
    """A width-1152 student with ``--impl pallas`` trains on the plain MLP
    with the note naming K2's envelope: past K1's envelope (1024), which
    K2 shares, neither fused kernel serves it."""
    rc = cli_main([*TRAIN, "--width", "1152", "--depth", "2", "--skip-at", "0", "--impl",
                   "pallas"])
    assert rc == 0
    out = capsys.readouterr().out
    assert NOTE in out and K2_NOTE in out
    assert re.search(r"^step 0: loss [0-9.]+ psnr", out, flags=re.M), out


@pytest.mark.parametrize("width, depth", [(384, 2), (512, 20), (1024, 2)],
                         ids=["w384", "w512_d20", "w1024"])
def test_cli_train_wide_student_runs_fused_without_note(width, depth, monkeypatch, capsys):
    """A student within K1's envelope (width 384, 512 and 20 layers deep, or
    1024, past the wide kernels' 512) trains with ``--impl pallas`` through
    the fused path (K1 and K2; their plain versions on the CPU) with no
    note: K2's envelope is K1's."""
    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm

    seen = []
    real = fm.fused_nerf_mlp_backward_reference

    def spy(pk, *args, **kw):                      # K2's wrapper hands on its pack
        seen.append((pk.width, pk.v_width, pk.depth))
        return real(pk, *args, **kw)

    monkeypatch.setattr(fm, "fused_nerf_mlp_backward_reference", spy)
    rc = cli_main([*TRAIN, "--width", str(width), "--depth", str(depth), "--skip-at", "0",
                   "--impl", "pallas"])
    assert rc == 0
    out = capsys.readouterr().out
    assert NOTE not in out and "fused backward K2" not in out
    assert seen == [(width, 128, depth)] * 2          # K2's wrapper, coarse and fine
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


# ---- checkpoints, nerf_synthetic data and the front ends that use them ----

DATA_TRAIN = ["--checkpoint-every", "1", "--impl", "xla", "--batch-rays", "64",
              "--coarse-samples", "4", "--fine-samples", "8", "--log-every", "1"]
LR = 5e-4


def _recording(module, name, losses):
    """``module.name`` wrapped to record each step's loss at full
    precision (the log prints 5 decimals)."""
    real = getattr(module, name)

    def step(*args, **kw):
        state, metrics = real(*args, **kw)
        losses.append(float(metrics["loss"]))
        return state, metrics

    return step


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Both CLIs' ``train --data <scene> --init-weights <w>
    --checkpoint-dir <ck> --steps 2``, then the same command with
    ``--steps 4``, which resumes; the weights are JAX-initialized 8x256
    networks in the reference .bin format. Returns the paths, each run's
    losses and stdout."""
    import nerf_rs_tpu.parallel.train_sharded as jax_train_sharded
    import nerf_rs_tpu_torch.parallel.train_sharded as port_train_sharded
    from nerf_rs_tpu.cli import main as jax_cli_main

    root = tmp_path_factory.mktemp("both")
    scene = write_scene(root)
    weights = root / "w"
    for i, net in enumerate(("coarse", "fine")):
        save_nerf_params(weights / net, jax.tree_util.tree_map(
            np.asarray, init_nerf_params(jax.random.key(i))))
    runs = {"jax": {"ck": root / "jax_ck", "losses": [], "out": []},
            "port": {"ck": root / "port_ck", "losses": [], "out": []}}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("NERF_NO_COMPILE_CACHE", "1")
        m.setattr(jax_train_sharded, "sharded_train_step",
                  _recording(jax_train_sharded, "sharded_train_step", runs["jax"]["losses"]))
        m.setattr(port_train_sharded, "sharded_train_step",
                  _recording(port_train_sharded, "sharded_train_step", runs["port"]["losses"]))
        for steps in ("2", "4"):
            for name, main, extra in (("jax", jax_cli_main, []),
                                      ("port", cli_main, ["--device", "cpu"])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert main(["train", *extra, "--data", str(scene), "--init-weights",
                                 str(weights), "--checkpoint-dir", str(runs[name]["ck"]),
                                 "--steps", steps, *DATA_TRAIN]) == 0
                runs[name]["out"].append(buf.getvalue())
    return root, scene, weights, runs


def test_train_data_init_weights_and_resume_agree_with_jax(both_runs, tmp_path):
    """Both CLIs from the same weights on the same scene: the same log and
    a resume at step 2 in both.

    The first step starts from the same weights and batch, so its loss
    agrees to 1e-5 relative (tests/test_train.py's bar for one step).
    After that the two runs drift apart as any two float32 orders of the
    same sums do: Adam's first updates are close to lr * sign(g), so a
    near-zero gradient entry that the other order rounds to the other sign
    moves by up to 2 lr, and the fine samples follow the coarse sigmas'
    last bits (importance sampling), which the fine encode's 2^9 frequency
    amplifies. ``tools/torch_train_drift.py`` measures it on this job: the
    JAX package against itself on 1 and on 8 devices (the same ops, the
    rays summed in another order) leaves 21% of the fine network's
    entries more than 1e-5 apart after 4 steps, and the port against JAX
    moves the losses by up to 3.4e-4 relative, so the later steps are held
    to 1e-3 relative and the parameters after step 4 to max abs difference
    < 8 lr (the one-step bound of 2 lr, scaled by the steps): a coarse
    witness only, since Adam's first steps move an entry by about lr each
    whatever the gradient. The resumed step itself is held to JAX's: the
    port, resumed from JAX's own step-2 state, logs JAX's step-2 loss to
    1e-5 relative (the batch drawn from seed + 2, the key folded with the
    absolute step); the params it saves at step 3 are optax's Adam update
    of JAX's restored state with the port's gradients, to 1e-4 of a step
    (the restored moments, Adam's count carrying the schedule on); and
    against JAX's own step 3 its coarse network meets tests/test_train.py's
    one-step bound (max abs < 2 lr, under 0.1% of entries > 1e-5), its
    fine network max abs < 2 lr. The fine network's share of entries
    > 1e-5 cannot be held to 0.1% by two float32 implementations here:
    the coarse weights' last bits move 82 of the 768 fine samples by 1-2
    ulps, which the encode's 2^9 frequency turns into a 1e-3 relative
    difference of the fine trunk's gradients (1.2% of fine dense0's
    entries > 1e-5 after the step; JAX on 1 against 8 devices, whose
    samples agree, already leaves 0.13%)."""
    import jax.numpy as jnp
    import optax

    import nerf_rs_tpu_torch.parallel.train_sharded as port_train_sharded
    from nerf_rs_tpu.cli import main as jax_cli_main
    from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
    from nerf_rs_tpu.io.checkpoint import restore_checkpoint as jax_restore_checkpoint
    from nerf_rs_tpu.train import create_train_state as jax_create_train_state
    from nerf_rs_tpu.train import make_optimizer as jax_make_optimizer
    from nerf_rs_tpu_torch.io.checkpoint import restore_params, save_checkpoint
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.train import train_state_from_numpy

    root, scene, weights, runs = both_runs
    for run in runs.values():
        first, second = run["out"]
        assert f"initialized params from {weights} (fresh optimizer, step 0)" in first
        assert f"resumed from {run['ck'] / 'step_00000002'} at step 2" in second
        assert "initialized params" not in second
        assert [int(s) for s in re.findall(r"^step (\d+): loss", first + second, re.M)] == [
            0, 1, 2, 3]
        assert f"final checkpoint {run['ck'] / 'step_00000004'}" in second
    port, want = runs["port"]["losses"], runs["jax"]["losses"]
    assert len(port) == len(want) == 4
    np.testing.assert_allclose(port[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(port, want, rtol=1e-3)

    # The port resumed from JAX's step-2 state.
    template = jax_create_train_state(jax.random.key(0), JaxTrainConfig())
    jax_state = jax_restore_checkpoint(runs["jax"]["ck"] / "step_00000002", template)
    adam = jax_state.opt_state[0]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    save_checkpoint(tmp_path / "from_jax", train_state_from_numpy(
        to_np(jax_state.params), to_np(adam.mu), to_np(adam.nu), int(adam.count),
        int(jax_state.step), "cpu"))
    losses, grads = [], []
    real_step = port_train_sharded.sharded_train_step

    def step_recording_grads(*args, **kw):
        state, metrics = real_step(*args, **kw)
        losses.append(float(metrics["loss"]))
        grads.append({net: {name: w.grad.numpy().copy() for name, w in module.weights.items()}
                      for net, module in state.params.items()})
        return state, metrics

    with pytest.MonkeyPatch.context() as m:
        m.setattr(port_train_sharded, "sharded_train_step", step_recording_grads)
        assert cli_main(["train", "--device", "cpu", "--data", str(scene), "--checkpoint-dir",
                         str(tmp_path / "from_jax"), "--steps", "3", *DATA_TRAIN]) == 0
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], want[2], rtol=1e-5)

    # The resumed update (restored moments, Adam's count carrying the
    # schedule on): the params the port saves at step 3 are optax's Adam
    # step from JAX's own step-2 state with the port's gradients, within
    # 1e-4 of a step (test_torch_train.py::test_adam_matches_optax's bar).
    got, step = restore_params(tmp_path / "from_jax" / "step_00000003")
    assert step == 3
    before = to_np(jax_state.params)
    port_grads = {net: {layer: {part: grads[0][net][f"{layer}_{part}"] for part in parts}
                        for layer, parts in tree.items()} for net, tree in before.items()}
    updates, _ = jax_make_optimizer(JaxTrainConfig()).update(
        jax.tree_util.tree_map(jnp.asarray, port_grads), jax_state.opt_state, jax_state.params)
    adam_step = to_np(optax.apply_updates(jax_state.params, updates))
    # And against JAX's own step 3 (its gradients): the coarse network at
    # tests/test_train.py's one-step bound, max abs < 2 lr with under 0.1%
    # of entries more than 1e-5 apart; the fine network at max abs < 2 lr
    # (see the docstring).
    jax_step3 = to_np(jax_restore_checkpoint(runs["jax"]["ck"] / "step_00000003",
                                             template).params)
    for net, tree in jax_step3.items():
        for layer, parts in tree.items():
            for part, w in parts.items():
                mine = got[net][layer][part]
                np.testing.assert_allclose(mine, adam_step[net][layer][part], rtol=0,
                                           atol=1e-4 * LR, err_msg=f"{net}/{layer}/{part}")
                diff = np.abs(mine - w)
                assert diff.max() < 2 * LR, (net, layer, part, diff.max())
                if net == "coarse":
                    assert (diff > 1e-5).mean() < 1e-3, (layer, part, (diff > 1e-5).mean())
                assert np.abs(w - before[net][layer][part]).max() > 0     # the step moved it

    # A coarse witness of the whole 4-step run: see the docstring.
    assert cli_main(["export", "--checkpoint", str(runs["port"]["ck"] / "step_00000004"),
                     "-o", str(root / "port_exp")]) == 0
    with pytest.MonkeyPatch.context() as m:
        m.setenv("NERF_NO_COMPILE_CACHE", "1")
        assert jax_cli_main(["export", "--checkpoint", str(runs["jax"]["ck"] / "step_00000004"),
                             "-o", str(root / "jax_exp")]) == 0
    for net in ("coarse", "fine"):
        got, exported = (load_nerf_params(root / side / net) for side in ("port_exp", "jax_exp"))
        start = load_nerf_params(weights / net)
        for layer, parts in exported.items():
            for part, w in parts.items():
                diff = np.abs(got[layer][part] - w)
                assert diff.max() < 8 * LR, (net, layer, part, diff.max())
                assert np.abs(w - start[layer][part]).max() > 0        # they trained


def _guard_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


@pytest.mark.parametrize("case", ["family", "arch", "sidecar"])
def test_resume_guards_exit_with_jax_wording(both_runs, tmp_path, case):
    """Resuming with another family, another architecture or against a
    different model.json exits in both CLIs with the same message (paths
    aside), and leaves the sidecar as it was."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    _, scene, _, runs = both_runs
    flags = {"family": ["--model", "hashgrid", "--hash-levels", "2", "--hash-table-log2", "8"],
             "arch": ["--width", "128"], "sidecar": []}[case]
    messages = {}
    for name, main, extra in (("jax", jax_cli_main, []), ("port", cli_main, ["--device", "cpu"])):
        ck = tmp_path / name
        shutil.copytree(runs[name]["ck"], ck)
        if case == "sidecar":
            (ck / "model.json").write_text(json.dumps({"model": "hashgrid"}))
        sidecar = (ck / "model.json").read_text()
        with pytest.MonkeyPatch.context() as m:
            m.setenv("NERF_NO_COMPILE_CACHE", "1")
            msg = _guard_message(main, ["train", *extra, "--data", str(scene), "--checkpoint-dir",
                                        str(ck), "--steps", "6", *DATA_TRAIN, *flags])
        messages[name] = msg.replace(str(ck), "CK")
        assert (ck / "model.json").read_text() == sidecar
    assert messages["port"] == messages["jax"]
    assert {"family": "trains ['shared']", "arch": "different architecture",
            "sidecar": "holds a different model config"}[case] in messages["port"]


def test_init_weights_guards(both_runs, tmp_path):
    """--init-weights whose coarse/ has another architecture exits naming
    it; --init-weights with --model hashgrid exits; a .npz bundle warm
    starts as the .bin directory does."""
    _, scene, weights, _ = both_runs
    mixed = tmp_path / "mixed"
    shutil.copytree(weights / "fine", mixed / "fine")
    save_nerf_params(mixed / "coarse", jax.tree_util.tree_map(np.asarray, init_nerf_params(
        jax.random.key(2), arch=JaxArchConfig(width=128, v_width=64, depth=8, skip_at=4))))
    base = ["train", "--device", "cpu", "--data", str(scene), "--steps", "1", *DATA_TRAIN]
    msg = _guard_message(cli_main, [*base, "--init-weights", str(mixed)])
    assert f"--init-weights {mixed} coarse/ holds a different architecture" in msg
    msg = _guard_message(cli_main, [*base, "--init-weights", str(weights), "--model", "hashgrid"])
    assert "--init-weights supports the MLP family only" in msg
    from nerf_rs_tpu_torch.io.weights import load_nerf_params, save_bundle

    bundle = tmp_path / "w.npz"
    save_bundle(bundle, load_nerf_params(weights / "coarse"), load_nerf_params(weights / "fine"),
                "{}")
    assert cli_main([*base, "--init-weights", str(bundle)]) == 0


def test_sigterm_checkpoints_and_exits_0(tmp_path):
    """A port ``train`` subprocess on the CPU, stopped by SIGTERM after its
    first step line: exit 0, a final checkpoint line, a checkpoint of step
    >= 1 in the directory."""
    import signal
    import subprocess
    import sys

    scene = write_scene(tmp_path)
    ck = tmp_path / "ck"
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_rs_tpu_torch", "train", "--device", "cpu", "--data",
         str(scene), "--checkpoint-dir", str(ck), "--steps", "100000", "--batch-rays", "16",
         "--coarse-samples", "4", "--fine-samples", "4", "--width", "32", "--v-width", "16",
         "--depth", "2", "--skip-at", "0", "--log-every", "1"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**__import__("os").environ, "PYTHONPATH": str(repo)})
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("step "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(seen) + rest
    assert proc.returncode == 0, out
    assert "received signal 15: checkpointing and stopping" in out
    assert re.search(r"^final checkpoint .*step_\d{8}$", out, re.M), out
    from nerf_rs_tpu_torch.io.checkpoint import latest_checkpoint, restore_params

    assert restore_params(latest_checkpoint(ck))[1] >= 1


@pytest.fixture(scope="module")
def port_checkpoints(tmp_path_factory):
    """An MLP (64/32/4/2) and a hash-grid checkpoint trained 2 steps on
    the scene by the port's CLI."""
    root = tmp_path_factory.mktemp("ck")
    scene = write_scene(root)
    base = ["train", "--device", "cpu", "--data", str(scene), "--steps", "2", "--batch-rays",
            "32", "--coarse-samples", "4", "--fine-samples", "4"]
    assert cli_main([*base, "--width", "64", "--v-width", "32", "--depth", "4", "--skip-at", "2",
                     "--checkpoint-dir", str(root / "mlp")]) == 0
    assert cli_main([*base, "--model", "hashgrid", "--hash-levels", "4", "--hash-table-log2",
                     "10", "--hash-res-max", "32", "--checkpoint-dir", str(root / "hg")]) == 0
    return root


@pytest.mark.parametrize("family", ["mlp", "hg"])
def test_render_checkpoint_equals_render_image(port_checkpoints, tmp_path, capsys, family):
    """render --checkpoint writes render_image's frame of the restored
    params (with the sidecar's hash config) to the 8-bit level, bitwise."""
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.checkpoint import hashgrid_render_config, load_model_config
    from nerf_rs_tpu_torch.io.checkpoint import restore_params
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import quantize_u8
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    path = port_checkpoints / family / "step_00000002"
    out = tmp_path / "x.ppm"
    assert cli_main([*RENDER, "--checkpoint", str(path), "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"rendering checkpoint {path} (step 2)" in text
    params, _ = restore_params(path)
    cfg = RenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl="pallas")
    if family == "hg":
        cfg = hashgrid_render_config(load_model_config(path), cfg)
        coarse = fine = params["shared"]
        assert "(hashgrid/float32" in text
    else:
        coarse, fine = params["coarse"], params["fine"]
    cam = camera_from_golden(load_golden(LEGO / "tf_reference_samples.json"))
    want = render_image(coarse, fine, cam, 6, 8, random.key(0, "cpu"), cfg)
    np.testing.assert_array_equal(np.round(load_ppm(out) * 255).astype(np.uint8),
                                  quantize_u8(want))


def test_hashgrid_checkpoint_without_sidecar_exits_and_exports_nothing(port_checkpoints, tmp_path):
    hg = tmp_path / "hg"
    shutil.copytree(port_checkpoints / "hg", hg)
    path = hg / "step_00000002"
    msg = _guard_message(cli_main, ["export", "--checkpoint", str(path), "-o", str(tmp_path / "x")])
    assert "hashgrid checkpoints have no reference .bin equivalent" in msg
    assert not (tmp_path / "x").exists()
    (hg / "model.json").unlink()
    msg = _guard_message(cli_main, [*RENDER, "--checkpoint", str(path), "-o", str(tmp_path / "y")])
    assert "holds a shared-network (hashgrid) checkpoint but no model.json sidecar" in msg


def test_evaluate_weights_dir_of_the_teacher_and_checkpoint_dir(port_checkpoints, capsys):
    """evaluate --weights-dir on the lego assets renders the teacher
    against itself: >= 100 dB; --checkpoint-dir reports its step."""
    small = ["--device", "cpu", "--size", "8", "--coarse-samples", "4", "--fine-samples", "4"]
    assert cli_main(["evaluate", "--weights-dir", str(LEGO), *small]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"step -1: 8x8 PSNR vs teacher ([0-9.]+) dB \(mse [0-9.e+-]+\)", line)
    assert m and float(m.group(1)) >= 100.0, line
    for family in ("mlp", "hg"):
        assert cli_main(["evaluate", "--checkpoint-dir", str(port_checkpoints / family),
                         *small]) == 0
        assert re.search(r"^step 2: 8x8 PSNR vs teacher [0-9.]+ dB", capsys.readouterr().out,
                         re.M)
    assert "pass --checkpoint" in _guard_message(cli_main, ["evaluate", "--device", "cpu"])


def test_render_bare_export_weights(tmp_path):
    """`render --weights <export dir>` (coarse/ + fine/ only, no camera
    JSON) renders with the lego assets' camera, as tests/test_cli.py holds
    the JAX CLI to; a bare export without a camera to fall back to exits
    naming --camera."""
    arch = JaxArchConfig(width=64, v_width=32, depth=4, skip_at=2)
    export = tmp_path / "export"
    for i, net in enumerate(("coarse", "fine")):
        save_nerf_params(export / net, jax.tree_util.tree_map(np.asarray, init_nerf_params(
            jax.random.key(i), arch=arch)))
    out = tmp_path / "img.png"
    assert cli_main([*RENDER, "--weights", str(export), "-o", str(out)]) == 0
    with_camera = tmp_path / "cam.png"
    assert cli_main([*RENDER, "--weights", str(export), "--camera",
                     str(LEGO / "tf_reference_samples.json"), "-o", str(with_camera)]) == 0
    assert out.read_bytes() == with_camera.read_bytes()
    from nerf_rs_tpu_torch.io import weights

    with pytest.MonkeyPatch.context() as m:
        m.setattr(weights, "find_lego_assets", lambda: None)
        msg = _guard_message(cli_main, [*RENDER, "--weights", str(export), "-o", str(out)])
    assert "pass --camera" in msg


def test_info_prints_versions_and_assets(capsys):
    assert cli_main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert f"lego assets: {LEGO}" in out


def test_serve_subcommand_hands_its_flags_to_serve_main(monkeypatch):
    from nerf_rs_tpu_torch import serve

    seen = []
    monkeypatch.setattr(serve, "main", lambda argv: seen.append(argv) or 0)
    assert cli_main(["serve", "--port", "8123", "--device", "cpu", "--accel", "--accel-res", "32",
                     "--checkpoint", "ck/step_00000001", "--warmup"]) == 0
    assert seen == [["--port", "8123", "--host", "127.0.0.1", "--device", "cpu", "--warmup",
                     "--accel", "--accel-res", "32", "--checkpoint", "ck/step_00000001"]]
