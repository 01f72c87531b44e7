"""PyTorch port, serving: ``api`` (the RGBA contract, accel serving, init
from a bundle, the failure-keeps-state contract), ``serve`` (page, render
route, 400/404/500) over a loopback server, ``.npz`` bundles in both
directions between the packages, and ``render --accel`` through the CLI."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_rs_tpu.io.image import pixels_to_rgba as jax_pixels_to_rgba
from nerf_rs_tpu.io.weights import load_bundle as jax_load_bundle
from nerf_rs_tpu.io.weights import save_bundle as jax_save_bundle
from nerf_rs_tpu_torch import api, serve
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.io.image import load_ppm, pixels_to_rgba
from nerf_rs_tpu_torch.io.weights import load_bundle, load_scene_assets, save_bundle
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.render import render_image

torch.set_num_threads(1)

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
SMALL = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=256)


@pytest.fixture(autouse=True)
def fresh_state():
    api._state.clear()
    yield
    api._state.clear()


def psnr_u8(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 20 * np.log10(255.0) - 10 * np.log10(max(mse, 1e-12))


def test_rgba_contract():
    api.init_renderer(cfg=SMALL, device="cpu")
    buf = api.render_image_rgba(16, 16, seed=0)
    assert buf.shape == (16 * 16 * 4,) and buf.dtype == np.uint8
    assert (buf.reshape(16, 16, 4)[..., 3] == 255).all()
    img = render_image(api._state["params"]["coarse"], api._state["params"]["fine"],
                       api._state["camera"], 16, 16, random.key(0, "cpu"), SMALL)
    np.testing.assert_array_equal(buf, pixels_to_rgba(img))


def test_invalid_dims_rejected():
    api.init_renderer(cfg=SMALL, device="cpu")
    for w, h in ((0, 16), (16, -1)):
        with pytest.raises(ValueError):
            api.render_image_rgba(w, h)


def test_pixels_to_rgba_matches_jax():
    px = np.random.default_rng(0).uniform(-0.2, 1.2, size=(7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(pixels_to_rgba(torch.from_numpy(px)), jax_pixels_to_rgba(px))


def test_accel_serving_close_to_dense():
    """accel=True bakes a grid once (mask-only culling needs no per-size
    calibration; a compaction cfg calibrates per size) and serves images
    within the accel contract's 40 dB of the dense ones; accel=None keeps
    the grid, accel=False drops it."""
    api.init_renderer(cfg=SMALL, device="cpu")
    exact = api.render_image_rgba(16, 16, seed=0)
    api._state.clear()
    api.init_renderer(cfg=SMALL, accel=True, accel_res=32, device="cpu")
    baked = api._state["grid"]
    assert baked.resolution == 32 and 0.0 < float(baked.occ.float().mean()) < 0.5
    fast = api.render_image_rgba(16, 16, seed=0)
    assert (16, 16) not in api._state["size_cfgs"]
    assert psnr_u8(fast, exact) > 40.0
    api.init_renderer(cfg=SMALL.replace(accel_compact="scatter"), accel=True, accel_res=32)
    assert api._state["grid"] is baked                   # same weights, same resolution
    api.render_image_rgba(16, 16, seed=0)
    assert (16, 16) in api._state["size_cfgs"]
    api.init_renderer(cfg=SMALL.replace(ray_chunk=128))
    assert api._state["grid"] is baked
    api.init_renderer(accel=False)
    assert api._state["grid"] is None


def test_bundles_round_trip_between_the_packages(tmp_path):
    """A bundle the JAX package writes loads in the port, and the reverse,
    array for array, golden JSON included."""
    trees, golden = load_scene_assets(LEGO)
    jax_path, port_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_save_bundle(jax_path, trees["coarse"], trees["fine"], json.dumps(golden))
    save_bundle(port_path, NerfMLP(trees["coarse"]), trees["fine"],
                json.dumps(golden))
    for (got, got_golden), (want, want_golden) in (
            (load_bundle(jax_path), (trees, golden)),
            (jax_load_bundle(port_path, device_put=False), (trees, golden))):
        assert got_golden == want_golden
        for net in ("coarse", "fine"):
            assert sorted(got[net]) == sorted(want[net])
            for layer in want[net]:
                for part in ("kernel", "bias"):
                    np.testing.assert_array_equal(np.asarray(got[net][layer][part]),
                                                  want[net][layer][part])


def test_init_from_jax_bundle_serves_the_same_frames(tmp_path):
    trees, golden = load_scene_assets(LEGO)
    bundle = tmp_path / "scene.npz"
    jax_save_bundle(bundle, trees["coarse"], trees["fine"], json.dumps(golden))
    api.init_renderer(assets_dir=str(bundle), cfg=SMALL, device="cpu")
    from_bundle = api.render_image_rgba(8, 8, seed=0)
    api._state.clear()
    api.init_renderer(assets_dir=str(LEGO), cfg=SMALL, device="cpu")
    np.testing.assert_array_equal(from_bundle, api.render_image_rgba(8, 8, seed=0))


def test_failed_init_preserves_renderer(tmp_path):
    api.init_renderer(cfg=SMALL, device="cpu")
    before = api.render_image_rgba(8, 8, seed=0)
    snapshot = dict(api._state)
    with pytest.raises(FileNotFoundError):
        api.init_renderer(assets_dir=str(tmp_path / "nonexistent"), cfg=SMALL)
    with pytest.raises(NotImplementedError, match="item 10"):
        api.init_renderer(checkpoint=str(tmp_path / "ckpt"))
    assert api._state == snapshot
    np.testing.assert_array_equal(api.render_image_rgba(8, 8, seed=0), before)


@pytest.fixture()
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_serve_page_render_and_errors(server, monkeypatch):
    """The page, a real 16x8 render through the handler (the bytes of
    api.render_image_rgba), 400 for bad queries, 404 for unknown paths,
    500 with the message for a render that raises."""
    page = urllib.request.urlopen(server + "/").read().decode()
    assert "resp.ok" in page and "GPU" in page and "TPU" not in page
    api.init_renderer(cfg=SMALL, device="cpu")
    resp = urllib.request.urlopen(server + "/render?width=16&height=8&seed=3")
    meta = json.loads(resp.headers["x-render-meta"])
    body = resp.read()
    assert (meta["width"], meta["height"]) == (16, 8) and meta["device_ms"] > 0
    assert body == api.render_image_rgba(16, 8, seed=3).tobytes()
    for q in ("width=abc", "width=0&height=16", "width=4096&height=16", "seed=x"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{server}/render?{q}")
        assert e.value.code == 400, q
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404

    def failing(width, height, seed=0):
        raise RuntimeError("synthetic render failure")

    monkeypatch.setattr(api, "render_image_rgba", failing)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/render?width=16&height=8")
    assert e.value.code == 500 and "synthetic render failure" in e.value.read().decode()


def test_serve_main_refuses_checkpoints():
    with pytest.raises(NotImplementedError, match="item 10"):
        serve.main(["--checkpoint", "step_00000001", "--device", "cpu"])


def test_cli_render_accel_k3_writes_three_images(tmp_path, capsys):
    out, depth, acc = (tmp_path / f"{n}.ppm" for n in ("rgb", "depth", "acc"))
    rc = cli_main(["render", "--device", "cpu", "--width", "16", "--height", "16",
                   "--coarse-samples", "8", "--fine-samples", "16", "--ray-chunk", "64",
                   "--accel", "--accel-res", "16", "--sampling-impl", "pallas",
                   "--accel-cull-rays", "--depth-output", str(depth), "--acc-output", str(acc),
                   "-o", str(out)])
    assert rc == 0
    imgs = [load_ppm(p) for p in (out, depth, acc)]
    assert all(img.shape == (16, 16, 3) for img in imgs)
    assert imgs[2].max() > 0.5 and imgs[2].min() < 0.5        # the lego's silhouette
    text = capsys.readouterr().out
    assert "occupancy grid 16^3" in text and text.count("Wrote") == 3
