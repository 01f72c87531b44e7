"""PyTorch port, data-parallel training (``parallel/train_sharded.py``)
and the CLI across ranks, against the port's single-device step and the
JAX package's sharded step on a mesh of two devices.

A world of 2 is two real processes under gloo on the CPU
(``tests/torch_parallel_worker.py``); the CLI runs under ``python -m
torch.distributed.run --standalone --nproc-per-node 2``. A cross-process
all-reduce sums the gradients in another order than one process, so the
step is held to the one-step bound of ``tests/test_train.py`` against
``train_step`` and to ``tests/test_multihost.py``'s bars against JAX; in a
world of 1 it is ``train_step`` bit for bit."""

import datetime
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nerf_rs_tpu.parallel.train_sharded import sharded_train_step as jax_sharded_train_step
from nerf_rs_tpu.train import create_train_state as jax_create_train_state
from nerf_rs_tpu_torch import accel
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
from nerf_rs_tpu_torch.io.checkpoint import latest_checkpoint, restore_params
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.parallel import Mesh, make_mesh, multihost
from nerf_rs_tpu_torch.parallel.train_sharded import sharded_train_step, shard_batch
from nerf_rs_tpu_torch.train import nerf_loss, train_state_from_numpy, train_step
from test_torch_data import write_scene
from torch_parallel_worker import run_world

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(width=128, v_width=64, depth=4, skip_at=2)
JAX_CFG = JaxTrainConfig(batch_rays=64, arch=JaxArchConfig(**SMALL),
                         render=JaxRenderConfig(n_coarse=8, n_fine=8, ray_chunk=64))
CFG = TrainConfig(batch_rays=64, arch=ArchConfig(**SMALL),
                  render=RenderConfig(n_coarse=8, n_fine=8, ray_chunk=64))
QAT = dict(width=64, v_width=32, depth=4, skip_at=2)
JAX_QAT = JaxTrainConfig(batch_rays=64, arch=JaxArchConfig(**QAT), render=JaxRenderConfig(
    n_coarse=8, n_fine=16, ray_chunk=64, impl="int8qat"))
QAT_CFG = TrainConfig(batch_rays=64, arch=ArchConfig(**QAT), render=RenderConfig(
    n_coarse=8, n_fine=16, ray_chunk=64, impl="int8qat"))
LAUNCH_LIMIT_S = 120         # a torchrun launch that has not ended by then is killed
LR = CFG.lr_init


def np_batch(n, seed=0, origin=None):
    """tests/multihost_worker.py's train_batch (origins at 0, or the
    given point)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros((n, 3), np.float32) if origin is None else np.tile(
        np.asarray([origin], np.float32), (n, 1))
    return {"origins": origins, "dirs": dirs,
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32),
            "near": np.float32(2.0), "far": np.float32(6.0)}


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def jax_state_np(cfg):
    """JAX's initial state as numpy: (params, mu, nu, count, step)."""
    state = jax_create_train_state(jax.random.key(0), cfg)
    adam = state.opt_state[0]
    return (to_np(state.params), to_np(adam.mu), to_np(adam.nu), int(adam.count),
            int(state.step))


def port_params(state):
    return {net: {name: p.detach().numpy().copy() for name, p in module.weights.items()}
            for net, module in state.params.items()}


def flat_jax(params):
    return {net: {f"{layer}_{part}": np.asarray(a) for layer, parts in tree.items()
                  for part, a in parts.items()} for net, tree in params.items()}


def assert_within(got, want, max_abs, share, entry):
    """Every entry within ``max_abs``, under ``share`` of each leaf's
    entries more than ``entry`` apart."""
    for net, leaves in want.items():
        for name, w in leaves.items():
            diff = np.abs(got[net][name] - w)
            assert diff.max() < max_abs, (net, name, diff.max())
            assert (diff > entry).mean() < share, (net, name, (diff > entry).mean())


def shell_occupancy(res=16, box=6.5):
    """tests/test_torch_culled_train.py's shell: occupied for 2.8 < |x| <
    4.6 above z = -2, so that rays from the origin upwards cross it and
    rays downwards pass only through empty cells."""
    c = -box + (np.arange(res) + 0.5) * (2 * box / res)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    return (d > 2.8) & (d < 4.6) & (gz > -2.0)


def overflow_batch(n=512):
    """The first half of the rays upwards (through the shell), the second
    downwards (through empty cells only): with 2 ranks only rank 0's rows
    overflow a tight capacity."""
    b = np_batch(n, seed=3)
    d = b["dirs"]
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d[n // 2:, 2] *= -1.0
    b["dirs"] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return b


OVERFLOW_CFG = CFG.replace(batch_rays=512, render=CFG.render.replace(
    n_coarse=16, n_fine=16, ray_chunk=512, accel_compact="scatter",
    accel_coarse_capacity=0.01, accel_fine_capacity=0.01))
STATE = jax_state_np(JAX_CFG)
QAT_STATE = jax_state_np(JAX_QAT)
BATCH = np_batch(64, seed=1)
QAT_BATCH = np_batch(64, seed=0, origin=[0.0, -4.0, 1.0])
SHELL = accel.grid_from_numpy(shell_occupancy(), -6.5, 6.5, "cpu")


def train_cases(tmp):
    step = dict(kind="steps", state=STATE, batch=BATCH, seed=1, cfg=CFG)
    return [
        dict(step, name="two_steps", steps=2),
        dict(step, name="two_steps_again", steps=2),
        dict(step, name="stop_on_rank_1", steps=1, stop=[False, True]),
        dict(kind="steps", name="overflow", state=STATE, batch=overflow_batch(), seed=2,
             cfg=OVERFLOW_CFG, grid=SHELL, steps=1),
        dict(kind="steps", name="int8qat", state=QAT_STATE, batch=QAT_BATCH, seed=1,
             cfg=QAT_CFG, steps=2),
        dict(step, name="does_not_divide", batch=np_batch(63), steps=1, fatal=False),
        dict(kind="build", name="build", log=str(tmp / "build.log")),
    ]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_world2")
    return run_world(tmp, train_cases(tmp)), tmp


def steps_of(world, name, rank=0):
    res = world[0][rank][name]
    assert res["error"] is None, res["error"]
    return res["out"]


def port_step(state_np, batch, cfg, seed=1, steps=1):
    state = train_state_from_numpy(*state_np, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, m = train_step(state, tb, random.key(seed, "cpu"), cfg)
        out.append(({k: float(v) for k, v in m.items()}, port_params(state)))
    return out


def jax_sharded_steps(batch, cfg, steps):
    """JAX's sharded_train_step on a mesh of two devices from the same
    state (JAX's initial state, of which STATE and QAT_STATE are numpy
    copies), batch and key."""
    state = jax_create_train_state(jax.random.key(0), cfg)
    mesh = jax_make_mesh(jax.devices()[:2])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, m = jax_sharded_train_step(mesh, state, jb, jax.random.key(1), cfg)
        out.append(({k: float(v) for k, v in m.items()}, flat_jax(to_np(state.params))))
    return out


def test_sharded_step_meets_the_one_step_bound_against_train_step(world2):
    """One step of the 2-rank world against train_step on the whole batch
    from the same state: the loss to 1e-5 relative, the params within
    tests/test_train.py:106-112's bound (max < 2 lr, under 0.1% of each
    leaf's entries > 1e-5). Both ranks hold the same params."""
    got = steps_of(world2, "two_steps")[0]
    (want_m, want_p), = port_step(STATE, BATCH, CFG)
    np.testing.assert_allclose(got["metrics"]["loss"], want_m["loss"], rtol=1e-5)
    for k in ("mse_fine", "mse_coarse", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], want_m[k], rtol=1e-5, err_msg=k)
    assert_within(got["params"], want_p, 2 * LR, 1e-3, 1e-5)
    other = steps_of(world2, "two_steps", rank=1)[0]
    for net, leaves in got["params"].items():
        for name, w in leaves.items():
            assert np.array_equal(other["params"][net][name], w), (net, name)


def test_two_sharded_steps_match_jax_two_device_mesh(world2):
    """Two steps against JAX's sharded_train_step over two devices:
    tests/test_multihost.py:92-123's bars (loss rtol 1e-5; params < 4 lr,
    under 0.1% of each leaf's entries > 1e-4)."""
    got = steps_of(world2, "two_steps")
    want = jax_sharded_steps(BATCH, JAX_CFG, 2)
    for g, (wm, _) in zip(got, want):
        np.testing.assert_allclose(g["metrics"]["loss"], wm["loss"], rtol=1e-5)
    assert_within(got[-1]["params"], want[-1][1], 4 * LR, 1e-3, 1e-4)


def test_one_all_reduce_per_step(world2):
    """Each step makes one collective: the all-reduce of one flat buffer
    holding every gradient and the metrics."""
    for rank in world2[0]:
        for name in ("two_steps", "overflow", "int8qat"):
            for step in rank[name]["out"]:
                assert step["counts"] == {"all_reduce": 1}, (name, step["counts"])


def test_two_runs_are_bitwise_equal(world2):
    """The same job twice in one world: the reduction order is fixed, so
    the metrics and params are the same bits."""
    for rank in (0, 1):
        a, b = steps_of(world2, "two_steps", rank), steps_of(world2, "two_steps_again", rank)
        for sa, sb in zip(a, b):
            assert sa["metrics"] == sb["metrics"]
            for net, leaves in sa["params"].items():
                for name, w in leaves.items():
                    assert np.array_equal(sb["params"][net][name], w), (net, name)


def test_accel_overflow_is_pooled(world2):
    """Only rank 0's rows overflow the compaction capacity; the pooled
    accel_overflow (the mean of the ranks' indicators, as JAX's pmean) is
    > 0 on both ranks, and the live fractions are the ranks' mean."""
    state = train_state_from_numpy(*STATE, "cpu")
    b = {k: torch.as_tensor(v) for k, v in overflow_batch().items()}
    local = []
    for rank in (0, 1):
        rows = shard_batch(Mesh(size=2, rank=rank, device=torch.device("cpu")), b)
        ids = rank * 256 + torch.arange(256)
        local.append(nerf_loss(state.params, rows, random.key(2, "cpu"), OVERFLOW_CFG,
                               grid=SHELL, ray_ids=ids)[1])
    assert [float(m["accel_overflow"]) for m in local] == [1.0, 0.0]
    for rank in (0, 1):
        m = steps_of(world2, "overflow", rank)[0]["metrics"]
        assert m["accel_overflow"] == 0.5
        np.testing.assert_allclose(m["live_frac_coarse"], float(
            (local[0]["live_frac_coarse"] + local[1]["live_frac_coarse"]) / 2), rtol=1e-6)


def test_int8qat_student_steps_match_jax(world2):
    """The int8qat student of tests/test_quant.py:83-107 in the 2-rank
    world: its first step against JAX's sharded step over two devices (the
    loss to 1e-5 relative, the params within the one-step bound), and the
    second step's loss moved (the params moved under the QAT forward)."""
    got = steps_of(world2, "int8qat")
    want = jax_sharded_steps(QAT_BATCH, JAX_QAT, 1)
    np.testing.assert_allclose(got[0]["metrics"]["loss"], want[0][0]["loss"], rtol=1e-5)
    assert_within(got[0]["params"], want[0][1], 2 * QAT_CFG.lr_init, 1e-3, 1e-5)
    assert np.isfinite(got[1]["metrics"]["loss"])
    assert got[1]["metrics"]["loss"] != got[0]["metrics"]["loss"]


def test_stop_request_rides_in_the_all_reduce(world2):
    """Rank 1 alone asks to stop: both ranks read the pooled request (0.5
    > 0) from the step's one all-reduce, and the step is the same."""
    for rank in world2[0]:
        step = rank["stop_on_rank_1"]["out"][0]
        assert step["metrics"]["stop"] == 0.5 and step["counts"] == {"all_reduce": 1}
        assert step["metrics"]["loss"] == rank["two_steps"]["out"][0]["metrics"]["loss"]


def test_does_not_divide_raises_before_any_collective(world2):
    for rank in world2[0]:
        res = rank["does_not_divide"]
        assert res["error"].startswith("ValueError: batch of 63 rays does not divide over 2 "
                                       "devices"), res["error"]
        assert res["counts"] == {}


def test_kernels_build_once_per_host(world2):
    """multihost.load_kernels_in_turn: rank 0 loads the kernels before a
    barrier, rank 1 only after rank 0's load ended (load_library stubbed);
    one load a rank, one barrier."""
    world, tmp = world2
    events = {}
    for line in (tmp / "build.log").read_text().splitlines():
        what, rank, t = line.split()
        events[(what, int(rank))] = float(t)
    assert events[("start", 1)] >= events[("end", 0)], events
    for rank in world:
        assert rank["build"]["out"] == 1
        assert rank["build"]["counts"] == {"barrier": 1}


def test_initialize_for_a_card_sets_the_device_joins_then_loads_the_kernels(monkeypatch):
    """initialize(device="cuda") as torchrun's rank 1 of 2: the rank's card
    is made current first, then the NCCL group is joined bound to it, then
    the kernels are loaded in turn. The three are stubbed: nothing is
    launched here."""
    calls = []
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        ("join", backend, str(kw["device_id"]), kw["init_method"], kw["world_size"],
         kw["rank"])))
    monkeypatch.setattr(multihost, "load_kernels_in_turn", lambda: calls.append(("load",)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    assert multihost.initialize(device="cuda") is True
    assert calls == [("set_device", "cuda:1"), ("join", "nccl", "cuda:1", "env://", 2, 1),
                     ("load",)]


@pytest.mark.parametrize("grouped", [True, False], ids=["gloo_world_of_1", "no_process_group"])
def test_world_of_1_step_is_bitwise_train_step(tmp_path, monkeypatch, grouped):
    """In a world of 1 the all-reduce is the identity and the division by
    1.0 exact: two sharded steps equal train_step's bit for bit, with one
    all-reduce a step in a gloo world and none without a process group."""
    counts = {}
    real = dist.all_reduce

    def counted(*a, **k):
        counts["all_reduce"] = counts.get("all_reduce", 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(dist, "all_reduce", counted)
    tb = {k: torch.as_tensor(v) for k, v in BATCH.items()}
    want = train_state_from_numpy(*STATE, "cpu")
    got = train_state_from_numpy(*STATE, "cpu")
    if grouped:
        multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu",
                             timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh("cpu")
        assert (mesh.group is not None) == grouped
        for _ in range(2):
            want, wm = train_step(want, tb, random.key(1, "cpu"), CFG)
            got, gm = sharded_train_step(mesh, got, tb, random.key(1, "cpu"), CFG)
            assert set(gm) == set(wm)
            for k in wm:
                assert torch.equal(gm[k], wm[k]), k
    finally:
        multihost.shutdown()
    assert counts == ({"all_reduce": 2} if grouped else {})
    assert got.step == want.step == 2 and got.count == want.count == 2
    for net, leaves in port_params(want).items():
        for name, w in leaves.items():
            assert np.array_equal(port_params(got)[net][name], w), (net, name)


# --- the CLI across ranks ------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--steps", "2", "--batch-rays", "32", "--coarse-samples", "4",
              "--fine-samples", "4", "--width", "64", "--v-width", "32", "--depth", "2",
              "--skip-at", "0", "--log-every", "1"]
RENDER_ARGS = ["render", "--device", "cpu", "--width", "16", "--height", "16",
               "--coarse-samples", "8", "--fine-samples", "8", "--ray-chunk", "96"]


def torchrun(args, nproc=2):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc -m nerf_rs_tpu_torch ARGS`` in its own session."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", "nerf_rs_tpu_torch", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")})


def finish(proc, limit=LAUNCH_LIMIT_S):
    """The launch's output; its whole session is killed at ``limit``."""
    try:
        return proc.communicate(timeout=limit)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_cli_render_sharded_writes_the_unsharded_bytes(tmp_path):
    """render --sharded over 2 ranks: one file, byte for byte the unsharded
    render's; rank 0 alone prints and traces (one trace in --trace-dir)."""
    out = finish(torchrun([*RENDER_ARGS, "--sharded", "--trace-dir", str(tmp_path / "trace"),
                           "-o", str(tmp_path / "sharded.ppm")]))
    assert out.count("Wrote ") == 1, out
    assert "rays split over 2 rank(s)" in out
    assert len(list((tmp_path / "trace").iterdir())) == 1
    assert cli_main([*RENDER_ARGS, "-o", str(tmp_path / "single.ppm")]) == 0
    assert (tmp_path / "sharded.ppm").read_bytes() == (tmp_path / "single.ppm").read_bytes()


def test_cli_train_checkpoints_from_rank_0_within_4_lr_of_one_rank(tmp_path):
    """train for 2 steps over 2 ranks on a nerf_synthetic scene: one step
    log per step, one checkpoint directory written (rank 0's), whose params
    are within tests/test_multihost.py's 4 lr of the 1-rank run's."""
    scene = write_scene(tmp_path)
    args = ["train", *TRAIN_ARGS, "--data", str(scene)]
    out = finish(torchrun([*args, "--checkpoint-dir", str(tmp_path / "two")]))
    assert [int(s) for s in re.findall(r"^step (\d+): loss", out, re.M)] == [0, 1], out
    assert "mesh: 2 rank(s) (gloo)" in out
    assert out.count("final checkpoint") == 1
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == ["model.json",
                                                                    "step_00000002"]
    assert cli_main([*args, "--checkpoint-dir", str(tmp_path / "one")]) == 0
    got, _ = restore_params(tmp_path / "two" / "step_00000002")
    want, _ = restore_params(tmp_path / "one" / "step_00000002")
    for net, tree in want.items():
        for layer, parts in tree.items():
            for part, w in parts.items():
                assert np.abs(got[net][layer][part] - w).max() < 4 * LR, (net, layer, part)


def sigterm_after_first_step(proc, kill):
    """Read the launch until rank 0's first step line, then ``kill()``;
    returns everything printed."""
    seen = []
    for line in proc.stdout:
        seen.append(line)
        if line.startswith("step "):
            kill()
            break
    return "".join(seen) + finish(proc)


def test_cli_sigterm_to_torchrun_stops_both_ranks_after_the_same_step(tmp_path):
    """SIGTERM to the launcher after the first step line: torchrun sends
    SIGTERM to both ranks, they finish the step in flight, agree through
    the step's all-reduce that a stop was asked (read after one more step
    is queued), and stop after the same step (a rank that stepped on alone would wait in an all-reduce its peer
    never joins, and the launch would be killed); rank 0 writes one final
    checkpoint. The launcher itself then exits 1: torchrun re-raises the
    signal it received once its workers have ended."""
    scene = write_scene(tmp_path)
    ck = tmp_path / "ck"
    proc = torchrun(["train", *TRAIN_ARGS, "--steps", "100000", "--data", str(scene),
                     "--checkpoint-dir", str(ck)])
    out = sigterm_after_first_step(proc, lambda: proc.send_signal(signal.SIGTERM))
    assert "received signal 15: checkpointing and stopping" in out, out
    final = re.findall(r"^final checkpoint .*step_(\d{8})$", out, re.M)
    assert len(final) == 1, out
    assert restore_params(latest_checkpoint(ck))[1] == int(final[0]) >= 1
    assert "SignalException" in out and proc.returncode == 1, out


def test_cli_sigterm_to_one_rank_stops_both_after_the_same_step(tmp_path):
    """The two ranks started with torchrun's variables and SIGTERM sent to
    rank 1 alone: its stop request rides in the step's all-reduce, so rank
    0 stops after the same step; both exit 0, rank 0 writes the final
    checkpoint."""
    from torch_parallel_worker import free_port

    scene = write_scene(tmp_path)
    ck = tmp_path / "ck"
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    argv = [sys.executable, "-m", "nerf_rs_tpu_torch", "train", *TRAIN_ARGS, "--steps", "100000",
            "--data", str(scene), "--checkpoint-dir", str(ck)]
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in (0, 1)]
    try:
        out = sigterm_after_first_step(procs[0], lambda: procs[1].send_signal(signal.SIGTERM))
        out1 = finish(procs[1])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], out + out1
    assert "received signal" not in out          # rank 0 was not signalled
    final = re.findall(r"^final checkpoint .*step_(\d{8})$", out, re.M)
    assert len(final) == 1, out
    assert restore_params(latest_checkpoint(ck))[1] == int(final[0]) >= 1
    assert not re.search(r"^(step |final checkpoint)", out1, re.M), out1   # rank 1 is quiet
