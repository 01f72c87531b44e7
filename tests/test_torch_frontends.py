"""PyTorch port, the rest of the single-device front ends against the JAX
package: ``verify``, ``extract`` (``extract.py``), ``render --orbit`` and
``--trace-dir`` (``ops.rays.orbit_camera``, ``utils/profiling.py``), the
256x256 golden on a strip of rows, and the datasets' default device.

The same weights and numpy inputs go to both packages. On the CPU the
port's fused kernels run their plain versions; on the card ``extract``'s
lattice runs K1 bf16 (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import contextlib
import io
import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_rs_tpu.accel as jax_accel
import nerf_rs_tpu.extract as jax_extract
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.ops.rays import orbit_camera as jax_orbit_camera
from nerf_rs_tpu_torch import data, extract
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.image import load_ppm, save_ppm
from nerf_rs_tpu_torch.io.weights import load_nerf_params, save_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import camera_rays, orbit_camera
from nerf_rs_tpu_torch.render import _render_flat, render_image
from nerf_rs_tpu_torch.utils.profiling import Phases, Progress, device_trace
from test_torch_cli import LEGO

torch.set_num_threads(1)

GOLDEN = load_golden(LEGO / "tf_reference_samples.json")
CAM = camera_from_golden(GOLDEN)


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def lego_np():
    return {net: load_nerf_params(LEGO / net) for net in ("coarse", "fine")}


def test_datasets_default_to_the_card():
    """Both datasets resolve ``device=None`` to the CUDA card, as every
    entry point of the port does; an explicit device is kept."""
    import inspect

    assert data.resolve_device(None) == torch.device("cuda")
    assert data.resolve_device("cpu") == torch.device("cpu")
    for cls in (data.BlenderDataset, data.DistillationDataset):
        assert inspect.signature(cls).parameters["device"].default is None


# ---- verify ----

ERR_LINE = re.compile(r"^(coarse|fine) pixel (\[[^\]]*\]): max abs err ([0-9.e+-]+) \[(OK|FAIL)\]$",
                      re.M)


def verify_both(extra, weights=None):
    """Both CLIs' ``verify`` with ``extra`` flags: {name: (rc, stdout)}."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    w = ["--weights", str(weights)] if weights else []
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("NERF_NO_COMPILE_CACHE", "1")
        out["jax"] = run(jax_cli_main, ["verify", *w, *extra])
    out["port"] = run(cli_main, ["verify", "--device", "cpu", *w, *extra])
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_verify_matches_jax(impl):
    """verify on the lego networks: the same exit code (0) and example
    lines as JAX's, every per-pixel error within 1e-5 of JAX's printed one,
    relative to the example's largest |sigma| where that exceeds 1: the
    errors are taken at sigmas up to 213, where one f32 ulp is 1.5e-5, and
    two f32 sum orders of the 8x256 network move a sigma of 34 by 6e-5."""
    from nerf_rs_tpu_torch.io.golden import golden_examples

    scale = {(net, str(ex["pixel"])):
             max(1.0, float(np.abs(ex[f"{net}_sigma"]).max()))
             for ex in golden_examples(GOLDEN) for net in ("coarse", "fine")}
    out = verify_both(["--impl", impl])
    (jrc, jout), (prc, pout) = out["jax"], out["port"]
    assert jrc == prc == 0
    want, got = ERR_LINE.findall(jout), ERR_LINE.findall(pout)
    assert len(got) == len(want) == 6
    for (jn, jp, je, js), (pn, pp, pe, ps) in zip(want, got):
        assert (jn, jp, js) == (pn, pp, ps)
        assert abs(float(pe) - float(je)) <= 1e-5 * scale[(pn, pp)], (pn, pp, pe, je)
    assert re.search(r"^worst error [0-9.e+-]+ \(tolerance 0.01\)$", pout, re.M)


def test_verify_fails_on_perturbed_weights(tmp_path, lego_np):
    """Weights moved by noise fail the golden samples: both CLIs print
    FAIL lines and exit 1."""
    rng = np.random.default_rng(0)
    for net, tree in lego_np.items():
        save_nerf_params(tmp_path / net, {
            layer: {part: v + rng.normal(0.0, 0.05, v.shape).astype(np.float32)
                    for part, v in parts.items()} for layer, parts in tree.items()})
    shutil.copy(LEGO / "tf_reference_samples.json", tmp_path)
    out = verify_both(["--impl", "xla"], weights=tmp_path)
    for rc, text in out.values():
        assert rc == 1 and "[FAIL]" in text
    assert ([s for *_, s in ERR_LINE.findall(out["port"][1])]
            == [s for *_, s in ERR_LINE.findall(out["jax"][1])])


def test_verify_image_against_the_committed_golden():
    """verify --image renders the 64x64 16+32 key-0 frame above the 45 dB
    bar."""
    rc, out = run(cli_main, ["verify", "--device", "cpu", "--impl", "xla", "--image"])
    m = re.search(r"^image vs committed golden: ([0-9.]+) dB \[OK\] \(bar 45 dB, xla/float32\)$",
                  out, re.M)
    assert rc == 0 and m and float(m.group(1)) > 45.0, out


def test_verify_image_golden_flag(tmp_path):
    """--image-golden of a frame that is not the golden fails the image
    check (exit 1); a missing golden is reported as skipped."""
    wrong = tmp_path / "wrong.ppm"
    wrong.write_bytes(b"P6\n64 64\n255\n" + bytes(64 * 64 * 3))
    rc, out = run(cli_main, ["verify", "--device", "cpu", "--impl", "xla", "--image",
                             "--image-golden", str(wrong)])
    assert rc == 1 and "[FAIL] (bar 45 dB" in out
    rc, out = run(cli_main, ["verify", "--device", "cpu", "--impl", "xla", "--image",
                             "--image-golden", str(tmp_path / "missing.ppm")])
    assert rc == 0 and "image check SKIPPED: golden render not found" in out


# ---- extract ----

def sphere_sigma(r=32, radius=0.8, inside=50.0):
    """tests/test_extract.py's lattice: a ball with a linear falloff."""
    c = -2.0 + (np.arange(r) + 0.5) * (4.0 / r)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    return (inside * np.clip(1.0 - (d - radius) / 0.2, 0.0, 1.0)).astype(np.float32)


@pytest.fixture(scope="module")
def lego_lattice(lego_np):
    """The lego fine network's sigma on a 24^3 lattice over (-1.5, 1.5),
    JAX's plain f32 sweep, as numpy."""
    return np.asarray(jax_accel.density_grid(
        jax.tree_util.tree_map(jnp.asarray, lego_np["fine"]), resolution=24, aabb=(-1.5, 1.5),
        mlp_fn=jax_accel._oracle_grid_mlp_fn()))


@pytest.mark.parametrize("lattice", ["sphere", "lego", "empty"])
def test_voxel_mesh_and_ply_bytes_equal_jax(lattice, lego_lattice, tmp_path):
    """extract_voxel_mesh on one lattice gives JAX's vertices and faces
    bitwise, and save_ply JAX's bytes, with and without vertex colors;
    load_ply reads the file back as JAX's does."""
    sigma, iso, aabb = {"sphere": (sphere_sigma(), 25.0, (-2.0, 2.0)),
                        "lego": (lego_lattice, 10.0, (-1.5, 1.5)),
                        "empty": (np.zeros((8, 8, 8), np.float32), 1.0, (-2.0, 2.0))}[lattice]
    verts, faces = extract.extract_voxel_mesh(sigma, iso, aabb=aabb)
    want_v, want_f = jax_extract.extract_voxel_mesh(sigma, iso, aabb=aabb)
    assert verts.dtype == want_v.dtype and faces.dtype == want_f.dtype
    assert np.array_equal(verts, want_v) and np.array_equal(faces, want_f)
    assert (len(faces) > 100) == (lattice != "empty")
    colors = np.random.default_rng(0).uniform(size=verts.shape)
    for c in (None, colors):
        extract.save_ply(tmp_path / "port.ply", verts, faces, colors=c)
        jax_extract.save_ply(tmp_path / "jax.ply", want_v, want_f, colors=c)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
        got, want = extract.load_ply(tmp_path / "port.ply"), jax_extract.load_ply(tmp_path / "jax.ply")
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_vertex_normals_and_colors_match_jax(lego_lattice, lego_np):
    """vertex_normals equal JAX's to 1e-6; vertex_colors of the lego fine
    network through the plain f32 MLP within 1e-5 of JAX's oracle (the
    matmuls' f32 summation order)."""
    verts, faces = extract.extract_voxel_mesh(lego_lattice, 10.0, aabb=(-1.5, 1.5))
    np.testing.assert_allclose(extract.vertex_normals(verts, faces),
                               jax_extract.vertex_normals(verts, faces), atol=1e-6, rtol=0)
    got = extract.vertex_colors(lego_np["fine"], verts, faces, device="cpu")
    want = jax_extract.vertex_colors(jax.tree_util.tree_map(jnp.asarray, lego_np["fine"]), verts,
                                     faces)
    assert got.shape == (len(verts), 3) and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def assert_meshes_close(got, want, cell):
    """Two meshes of lattices that differ by bf16 rounding: face counts
    within 2%, and every vertex of each within 1/8 of a cell of the other's
    (only crossings whose interpolated position moved differ)."""
    (gv, gf), (wv, wf) = got, want
    assert abs(len(gf) - len(wf)) <= 0.02 * len(wf), (len(gf), len(wf))
    for a, b in ((gv, wv), (wv, gv)):
        d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(axis=1)
        assert d.max() <= cell / 8, d.max()


def test_extract_scene_mesh_matches_jax(lego_np):
    """extract_scene_mesh on the lego networks at R = 24 over (-1.5, 1.5):
    both sweep the fine network through their fused K1 in bf16 (the
    port's plain version here, JAX's Pallas kernel in interpret mode),
    whose sums round differently, so the meshes are held to
    assert_meshes_close: face counts within 2%, vertices within 1/8 of a
    cell."""
    kw = dict(resolution=24, aabb=(-1.5, 1.5), iso=10.0)
    got = extract.extract_scene_mesh(lego_np["coarse"], lego_np["fine"], device="cpu", **kw)
    want = jax_extract.extract_scene_mesh(*(jax.tree_util.tree_map(jnp.asarray, lego_np[n])
                                            for n in ("coarse", "fine")), **kw)
    assert len(got[1]) > 1000
    assert_meshes_close(got, want, 3.0 / 24)


def test_cli_extract_matches_jax(tmp_path):
    """Both CLIs' extract at R = 24 over +-1.5 (tests/test_extract.py's
    command): colored meshes held to assert_meshes_close, inside the box,
    the port's file the save_ply of its own extract_scene_mesh."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    argv = ["extract", "--resolution", "24", "--extent", "1.5", "--iso", "10"]
    with pytest.MonkeyPatch.context() as m:
        m.setenv("NERF_NO_COMPILE_CACHE", "1")
        assert run(jax_cli_main, [*argv, "-o", str(tmp_path / "jax.ply")])[0] == 0
    rc, out = run(cli_main, [*argv, "--device", "cpu", "-o", str(tmp_path / "port.ply")])
    assert rc == 0
    assert re.search(r"^wrote .*port\.ply: [0-9,]+ vertices, [0-9,]+ triangles \(vertex colors\) "
                     r"\(24\^3 lattice, iso 10\.0, [0-9.]+s\)$", out, re.M), out
    got, want = extract.load_ply(tmp_path / "port.ply"), jax_extract.load_ply(tmp_path / "jax.ply")
    assert np.all(np.abs(got[0]) <= 1.5 + 1e-5)
    assert_meshes_close(got, want, 3.0 / 24)
    head = (tmp_path / "port.ply").read_text().splitlines()
    assert "property uchar red" in head[:12]


def test_cli_extract_without_a_surface_exits():
    with pytest.raises(SystemExit) as e:
        cli_main(["extract", "--device", "cpu", "--resolution", "8", "--iso", "1e9",
                  "-o", "unused.ply"])
    assert "no surface at iso=1000000000.0" in str(e.value.code)


# ---- render --orbit, --trace-dir ----

@pytest.mark.parametrize("angle", [0.0, 0.5, 2.0943951023931953, np.pi, 5.0])
def test_orbit_camera_matches_jax(angle):
    """orbit_camera within 1e-6 of JAX's; angle 0 the identity exactly."""
    got, want = orbit_camera(CAM, angle), jax_orbit_camera(jax_camera_from_golden(GOLDEN), angle)
    for field in ("position", "forward", "up"):
        np.testing.assert_allclose(getattr(got, field), np.asarray(getattr(want, field)),
                                   atol=1e-6, rtol=0)
        assert getattr(got, field).dtype == np.float32
        if angle == 0.0:
            assert np.array_equal(getattr(got, field), np.asarray(getattr(CAM, field)))
    assert (got.near, got.far, got.alpha_width) == (CAM.near, CAM.far, CAM.alpha_width)


RENDER = ["render", "--device", "cpu", "--width", "8", "--height", "6", "--coarse-samples", "4",
          "--fine-samples", "4", "--ray-chunk", "16"]


def test_cli_render_orbit_frames_equal_render_image(tmp_path, lego_np):
    """render --orbit 3 writes turn_000..002 and the depth maps beside them;
    each frame is bitwise render_image at orbit_camera(2 pi i / 3), and
    frame 0 the plain render of the same flags."""
    rc, out = run(cli_main, [*RENDER, "--orbit", "3", "-o", str(tmp_path / "turn.ppm"),
                             "--depth-output", str(tmp_path / "depth.ppm")])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("turn_*.ppm")) == [
        "turn_000.ppm", "turn_001.ppm", "turn_002.ppm"]
    assert sorted(p.name for p in tmp_path.glob("depth_*.ppm")) == [
        "depth_000.ppm", "depth_001.ppm", "depth_002.ppm"]
    assert re.search(r"Rendering completed in [0-9.]+ seconds \([0-9,]+ rays/s", out)
    cfg = RenderConfig(n_coarse=4, n_fine=4, ray_chunk=16)
    coarse, fine = (NerfMLP(lego_np[n]) for n in ("coarse", "fine"))
    for i in range(3):
        img = render_image(coarse, fine, orbit_camera(CAM, 2.0 * np.pi * i / 3), 6, 8,
                           random.key(0, "cpu"), cfg, device="cpu")
        save_ppm(tmp_path / "want.ppm", img, 6, 8)
        assert (tmp_path / f"turn_{i:03d}.ppm").read_bytes() == (tmp_path / "want.ppm").read_bytes()
    assert run(cli_main, [*RENDER, "-o", str(tmp_path / "plain.ppm")])[0] == 0
    assert (tmp_path / "plain.ppm").read_bytes() == (tmp_path / "turn_000.ppm").read_bytes()
    assert (load_ppm(tmp_path / "turn_000.ppm") != load_ppm(tmp_path / "turn_001.ppm")).any()


def test_cli_render_trace_dir_writes_a_chrome_trace(tmp_path):
    """render --trace-dir writes one Chrome trace of the frames, with the
    render's torch ops in it, and says where."""
    rc, out = run(cli_main, [*RENDER, "-o", str(tmp_path / "t.ppm"), "--trace-dir",
                             str(tmp_path / "trace")])
    assert rc == 0
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and f"profiler trace written to {traces[0]}" in out
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


# ---- utils/profiling.py ----

def test_phases_and_progress(capsys):
    """tests/test_cli.py::test_profiling_utils on the port, and Phases.sync
    on a nested value of CPU tensors."""
    ph = Phases()
    for _ in range(2):
        with ph("a"):
            Phases.sync({"x": [torch.ones(2)]})
    with ph("b"):
        Phases.sync(None)
    totals = ph.report()
    assert ph.counts == {"a": 2, "b": 1} and set(totals) == {"a", "b"}
    prog = Progress(100, interval=0.0)
    prog.update(50)
    prog.update(50)
    out = capsys.readouterr().out
    assert "100/100" in out and "  a " in out


def test_device_trace_on_the_cpu(tmp_path):
    """device_trace(None) is a no-op; with a directory it writes the
    trace of its body; a body's exception propagates and writes none; a
    directory that cannot be made raises rather than running untraced."""
    with device_trace(None) as path:
        assert path is None
    with device_trace(str(tmp_path / "t")) as path:
        torch.ones(8) @ torch.ones(8)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::dot" for e in events)
    with pytest.raises(ValueError, match="body"):
        with device_trace(str(tmp_path / "u")) as path:
            raise ValueError("body")
    assert not path.exists()
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        with device_trace(str(tmp_path / "file")):
            pass


# ---- the 256x256 golden ----

def test_render_strip_vs_committed_fullres_golden(lego_np):
    """The port's counterpart of tests/test_render.py's strip test: centre
    rows of the 256x256 64+128 key-0 frame through _render_flat with their
    global ray ids, against the same rows of the committed golden above
    45 dB. Each ray draws from the stream of its global id, so the rows
    are bitwise the full frame's (chunk invariance) and the check is as
    strict as the whole frame. 4 rows (126-129): 16 take about 27 s on one
    CPU core here."""
    r0, r1 = 126, 130
    _, dirs = camera_rays(CAM, 256, 256, "cpu")
    with torch.no_grad():
        strip = _render_flat(NerfMLP(lego_np["coarse"]), NerfMLP(lego_np["fine"]),
                             torch.as_tensor(CAM.position), dirs[r0:r1].reshape(-1, 3), CAM.near,
                             CAM.far, random.key(0, "cpu"),
                             RenderConfig(n_coarse=64, n_fine=128, ray_chunk=4096),
                             ray_id_base=r0 * 256)
    ref = load_ppm(LEGO.parents[1] / "tests" / "goldens" / "lego_256x256_64c128f_key0.ppm")
    mse = float(np.mean((strip.numpy().reshape(r1 - r0, 256, 3) - ref[r0:r1]) ** 2))
    assert -10.0 * np.log10(max(mse, 1e-12)) > 45.0
    assert np.abs(ref[r0:r1] - 1.0).max() > 0.2                     # the rows cross the object
