"""One rank of the PyTorch port's multi-process tests.

    python tests/torch_parallel_worker.py JOB OUT_DIR

``tests/test_torch_parallel*.py`` start one process per rank
(:func:`run_world`) with
torchrun's variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, and
``MASTER_ADDR``/``MASTER_PORT`` or ``TORCH_WORLD_INIT``, a ``file://``
store), on the CPU under gloo. ``JOB`` is a pickled list of cases; each
rank runs them in order, counts the ``torch.distributed`` collectives each
one makes, and writes ``OUT_DIR/rank<r>.pt``: per case its result, the
counts and the error it raised. Imports no JAX.
"""

import datetime
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

torch.set_num_threads(1)

COLLECTIVES = ("all_reduce", "broadcast", "barrier", "all_gather", "all_gather_single",
               "all_gather_into_tensor", "gather", "reduce", "scatter", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "send", "recv", "all_gather_object",
               "broadcast_object_list")
COUNTS = {}
REPO = Path(__file__).resolve().parents[1]
WORLD_LIMIT_S = 240          # a world that has not ended by then is killed


def count_collectives() -> None:
    """Wrap every collective of ``torch.distributed`` with a counter."""
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def counted(*args, _fn=fn, _name=name, **kw):
            COUNTS[_name] = COUNTS.get(_name, 0) + 1
            return _fn(*args, **kw)

        setattr(dist, name, counted)


def run_image(case, mesh):
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel.render_sharded import render_image_sharded

    return render_image_sharded(case["coarse"], case["fine"], case["camera"], case["h"],
                                case["w"], random.key(case["seed"], "cpu"), case["cfg"],
                                mesh=mesh, grid=case.get("grid"))


def run_aux(case, mesh):
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel.render_sharded import render_image_aux_sharded

    return render_image_aux_sharded(case["coarse"], case["fine"], case["camera"], case["h"],
                                    case["w"], random.key(case["seed"], "cpu"), case["cfg"],
                                    mesh=mesh, grid=case.get("grid"))


def run_multihost(case, mesh):
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel.multihost import render_image_multihost

    return render_image_multihost(case["coarse"], case["fine"], case["camera"], case["h"],
                                  case["w"], random.key(case["seed"], "cpu"), case["cfg"],
                                  grid=case.get("grid"), mesh=mesh)


def run_steps(case, mesh):
    """``case["steps"]`` sharded steps from a state given as numpy trees
    (``train.train_state_from_numpy``) on one batch and key -> per step
    the metrics, the collective counts and the params after it."""
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel.train_sharded import sharded_train_step
    from nerf_rs_tpu_torch.train import train_state_from_numpy

    state = train_state_from_numpy(*case["state"], "cpu")
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    key = random.key(case["seed"], "cpu")
    stop = case.get("stop")                      # None, or one request a rank
    steps = []
    for _ in range(case["steps"]):
        COUNTS.clear()
        state, metrics = sharded_train_step(mesh, state, batch, key, case["cfg"],
                                            grid=case.get("grid"),
                                            stop=None if stop is None else stop[mesh.rank])
        params = {net: {name: p.detach().numpy().copy() for name, p in module.weights.items()}
                  for net, module in state.params.items()}
        steps.append({"metrics": {name: float(v) for name, v in metrics.items()},
                      "counts": dict(COUNTS), "params": params})
    return steps


def run_build(case, mesh):
    """``multihost.load_kernels_in_turn`` with ``_build.load_library``
    stubbed: each rank logs when its load starts and ends; rank 0's takes
    a while. Returns how many loads the rank made."""
    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.parallel import multihost

    log = Path(case["log"])
    loads = []

    def stub():
        with open(log, "a") as f:
            f.write(f"start {mesh.rank} {time.time()!r}\n")
        if mesh.rank == 0:
            time.sleep(0.5)
        with open(log, "a") as f:
            f.write(f"end {mesh.rank} {time.time()!r}\n")
        loads.append(mesh.rank)

    real = _build.load_library
    _build.load_library = stub
    try:
        multihost.load_kernels_in_turn()
    finally:
        _build.load_library = real
    return len(loads)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path: Path, cases, n: int = 2, env_init: bool = False):
    """``cases`` in a world of ``n`` worker processes (gloo, the CPU) ->
    each rank's results. ``env_init``: the world from torchrun's
    MASTER_ADDR/MASTER_PORT (else a file:// store in ``tmp_path``). The
    world is killed after WORLD_LIMIT_S."""
    out = tmp_path / "out"
    out.mkdir()
    job = tmp_path / "job.pkl"
    job.write_bytes(pickle.dumps(list(cases)))
    env = {**os.environ, "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    if env_init:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    else:
        env["TORCH_WORLD_INIT"] = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(job), str(out)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + WORLD_LIMIT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


RUNNERS = {"image": run_image, "aux": run_aux, "multihost": run_multihost, "steps": run_steps,
           "build": run_build}


def main(job: str, out_dir: str) -> int:
    from nerf_rs_tpu_torch.parallel import make_mesh, multihost

    count_collectives()
    joined = multihost.initialize(os.environ.get("TORCH_WORLD_INIT"), device="cpu",
                                  timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh("cpu")
    with open(job, "rb") as f:
        cases = pickle.load(f)
    results = {"initialize": joined, "mesh": (mesh.size, mesh.rank, str(mesh.device)),
               "default_device": str(make_mesh().device)}
    for case in cases:
        COUNTS.clear()
        try:
            out = RUNNERS[case["kind"]](case, mesh)
            err = None
        except Exception as e:                      # reported to the test, not hidden
            out, err = None, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        results[case["name"]] = {"out": out, "counts": dict(COUNTS), "error": err}
        if err is not None and case.get("fatal", True):
            break
    torch.save(results, Path(out_dir) / f"rank{mesh.rank}.pt")
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
