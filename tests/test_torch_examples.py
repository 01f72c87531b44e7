"""The port's examples gallery (``examples_torch/``) on the CPU.

Every script runs as a real subprocess with ``--cpu`` at the tiny sizes of
``tests/test_examples.py`` (and 07, 13, 04 and 06, which that file leaves
out: 04 and 06 each launch a world of two gloo processes). Each must exit
0 and print its key lines; without ``--cpu`` and with no card each must
exit non-zero with a message. Three scripts are held to their JAX
counterparts, run with the same flags through the plain f32 path with the
same threefry streams: 01 and 08 every byte of the written images within
1 u8 level; 05 the printed occupancy within 0.5 points and every frame it
renders (captured by ``tests/torch_example_capture.py``) within 1 u8 level
on at least 99% of the bytes (a ray through a grid cell that flips between
the packages may differ). No script imports JAX or the JAX package.

The subprocesses run a few at a time in one module fixture.
"""

import ast
import inspect
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from nerf_rs_tpu_torch.io.image import load_png, quantize_u8

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "examples_torch"
SCRIPTS = sorted(p.name for p in PORT.glob("[0-9][0-9]_*.py"))
CAPTURE = ROOT / "tests" / "torch_example_capture.py"
PARALLEL = 3
TIMEOUT_S = 600
U8_LEVEL = 1
OCC_POINTS = 0.5
SHARE_05 = 0.99


def _args(tmp: Path) -> dict:
    """Each port script's tiny --cpu flags."""
    return {
        "01_render.py": ["--size", "16", "--out", str(tmp / "p01.png")],
        "02_fused_kernel.py": ["--n", "256"],
        "03_train_distillation.py": ["--steps", "2", "--batch-rays", "64",
                                     "--ckpt", str(tmp / "ex03"), "--export", str(tmp / "ex03_bin")],
        "04_multichip_render.py": ["--size", "16"],
        "05_occupancy_grid.py": ["--size", "16", "--resolution", "16"],
        "06_multihost.py": [],
        "07_accel_training.py": ["--steps", "3", "--batch-rays", "64", "--resolution", "16"],
        "08_turntable.py": ["--frames", "2", "--size", "16", "--outdir", str(tmp / "p08")],
        "09_student_distillation.py": ["--steps", "2", "--batch-rays", "64", "--eval-size", "8"],
        "10_geometry_export.py": ["--resolution", "16", "--out", str(tmp / "p10.ply")],
        "11_hashgrid.py": ["--steps", "2", "--batch-rays", "64", "--levels", "2",
                           "--table-log2", "10", "--res-max", "16", "--eval-size", "8",
                           "--out", str(tmp / "p11.png")],
        "12_int8_quantization.py": ["--size", "16", "--steps", "2", "--batch-rays", "64"],
        "13_single_pass_serving.py": ["--size", "16", "--accel-res", "16",
                                      "-o", str(tmp / "p13.png")],
    }


def _jobs(tmp: Path) -> dict:
    """Name -> (argv, cwd): the port scripts with --cpu (05 through the
    frame capture), the same scripts without it, and the JAX scripts the
    port is held to."""
    py = sys.executable
    args = _args(tmp)
    jobs = {}
    for name in SCRIPTS:
        argv = [py, str(PORT / name), "--cpu", *args[name]]
        if name == "05_occupancy_grid.py":
            argv = [py, str(CAPTURE), "nerf_rs_tpu_torch", str(tmp / "p05.npz"),
                    str(PORT / name), "--cpu", *args[name]]
        jobs[("port", name)] = (argv, tmp)
        jobs[("no card", name)] = ([py, str(PORT / name), *args[name]], tmp)
    jax_dir = ROOT / "examples"
    jobs[("jax", "01_render.py")] = (
        [py, str(jax_dir / "01_render.py"), "--cpu", "--size", "16", "--out", str(tmp / "j01.png")],
        tmp)
    jobs[("jax", "05_occupancy_grid.py")] = (
        [py, str(CAPTURE), "nerf_rs_tpu", str(tmp / "j05.npz"), str(jax_dir / "05_occupancy_grid.py"),
         "--cpu", *args["05_occupancy_grid.py"]], tmp)
    jobs[("jax", "08_turntable.py")] = (
        [py, str(jax_dir / "08_turntable.py"), "--cpu", "--frames", "2", "--size", "16",
         "--outdir", str(tmp / "j08")], tmp)
    return jobs


def _run(argv, cwd):
    # No card is visible to the scripts, wherever the tests run.
    env = {**os.environ, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(argv, capture_output=True, text=True, timeout=TIMEOUT_S, env=env,
                          cwd=cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples_torch")
    jobs = _jobs(tmp)
    with ThreadPoolExecutor(PARALLEL) as pool:
        futures = {key: pool.submit(_run, *job) for key, job in jobs.items()}
        return tmp, {key: f.result() for key, f in futures.items()}


def _ok(r, what):
    assert r.returncode == 0, f"{what} failed (rc {r.returncode}):\n{r.stdout}\n{r.stderr}"
    return r.stdout


def _check_output(name, out, tmp):
    """Each script's key lines."""
    if name == "02_fused_kernel.py":
        rgb = float(re.search(r"max \|rgb - oracle\| += (\S+)", out).group(1))
        sigma = float(re.search(r"max \|sigma - oracle\| = (\S+)", out).group(1))
        assert rgb <= 1e-4 and sigma <= 1e-3, out
    elif name == "04_multichip_render.py":
        assert "sharded == single-device, bitwise: True" in out, out
    elif name == "05_occupancy_grid.py":
        assert "ray-culled render bitwise equal: True" in out, out
    elif name == "06_multihost.py":
        assert "multihost == single-device, bitwise: True" in out, out
        assert load_png(tmp / "lego_multihost.png").shape == (64, 64, 3)
    elif name == "13_single_pass_serving.py":
        assert load_png(tmp / "p13.png").shape == (16, 16, 3)
    elif name == "03_train_distillation.py":
        assert (tmp / "ex03_bin" / "fine" / "shapes.txt").exists()


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_runs_on_the_cpu(runs, name):
    tmp, results = runs
    _check_output(name, _ok(results[("port", name)], name), tmp)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_without_a_card_exits_with_a_message(runs, name):
    r = runs[1][("no card", name)]
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr and "--cpu" in r.stderr, r.stderr


def _u8_diff(a, b):
    return np.abs(quantize_u8(a).astype(np.int16) - quantize_u8(b).astype(np.int16))


@pytest.mark.parametrize("name,files", [
    ("01_render.py", [("p01.png", "j01.png")]),
    ("08_turntable.py", [(f"p08/frame_00{i}.png", f"j08/frame_00{i}.png") for i in range(2)]),
])
def test_images_match_the_jax_script(runs, name, files):
    tmp, results = runs
    _ok(results[("port", name)], name)
    _ok(results[("jax", name)], f"examples/{name}")
    for port_png, jax_png in files:
        got, want = load_png(tmp / port_png), load_png(tmp / jax_png)
        assert got.shape == want.shape == (16, 16, 3)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert int(diff.max()) <= U8_LEVEL, (port_png, int(diff.max()))


def test_occupancy_grid_matches_the_jax_script(runs):
    tmp, results = runs
    name = "05_occupancy_grid.py"
    out = _ok(results[("port", name)], name)
    jax_out = _ok(results[("jax", name)], f"examples/{name}")

    def occupancy(text):
        return float(re.search(r"([\d.]+)% occupied", text).group(1))

    assert abs(occupancy(out) - occupancy(jax_out)) <= OCC_POINTS, (out, jax_out)
    got, want = np.load(tmp / "p05.npz"), np.load(tmp / "j05.npz")
    assert len(got.files) == len(want.files) == 4      # exact, culled, packed, compacted
    for key in want.files:
        assert got[key].shape == want[key].shape == (16, 16, 3)
        share = float(np.mean(_u8_diff(got[key], want[key]) <= U8_LEVEL))
        assert share >= SHARE_05, (key, share)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_imports_neither_jax_nor_the_jax_package(name):
    mods = list(_imports(PORT / name))
    assert any(m.startswith("nerf_rs_tpu_torch") for m in mods)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "nerf_rs_tpu", "flax", "optax")]
    assert not bad, bad


def test_gallery_mirrors_the_jax_gallery():
    assert SCRIPTS == sorted(p.name for p in (ROOT / "examples").glob("[0-9][0-9]_*.py"))
    assert len(SCRIPTS) == 13 and (PORT / "README.md").exists()


@pytest.mark.parametrize("name", SCRIPTS)
def test_chip_smoke_runs_and_checks_every_example(name):
    """chip_smoke.py's phase 28 runs every script on the card and has a
    check of its own for each one's output (a script without one fails
    the phase there)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert name in {script for script, _, _ in chip_smoke.EXAMPLES}
    assert f'script == "{name}"' in inspect.getsource(chip_smoke.check_example)
