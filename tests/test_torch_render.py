"""PyTorch port, renderer: render_rays against the JAX render_rays, the
lego frame against the committed golden, the import boundary and the CLI."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.ops.rays import camera_rays as jax_camera_rays
from nerf_rs_tpu.render import render_rays as jax_render_rays
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.image import load_ppm
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models.mlp import arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.render import render_image, render_rays

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LEGO = REPO / "assets" / "lego_rust"
SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    # A denser field than the init gives, so that weights and the
    # importance PDF are far from uniform.
    out["alpha"]["bias"] += np.float32(2.0)
    return out


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-20))


@pytest.fixture(scope="module")
def golden():
    return load_golden(LEGO / "tf_reference_samples.json")


@functools.lru_cache(maxsize=None)
def jax_case(n_fine, side, seed, return_aux):
    """One JAX render of side x side golden-camera rays with the SMALL
    nets of seeds (seed, seed + 1), key seed // 2 and ray ids from 1000 +
    seed, kept for both of the port's impls -> (inputs, JAX output)."""
    golden = load_golden(LEGO / "tf_reference_samples.json")
    pc, pf = np_params(SMALL, seed), np_params(SMALL, seed + 1)
    _, dirs = jax_camera_rays(jax_camera_from_golden(golden), side, side)
    dirs = np.array(dirs).reshape(-1, 3)
    ids = np.arange(side * side, dtype=np.int32) + 1000 + seed
    cam = camera_from_golden(golden)
    want = jax_render_rays(
        jax.tree_util.tree_map(jnp.asarray, pc), jax.tree_util.tree_map(jnp.asarray, pf),
        jnp.asarray(cam.position), jnp.asarray(dirs), cam.near, cam.far,
        jax.random.key(seed // 2), JaxRenderConfig(n_coarse=8, n_fine=n_fine),
        ray_ids=jnp.asarray(ids), return_aux=return_aux)
    return (pc, pf, cam, dirs, ids), want


def port_case(inputs, n_fine, seed, impl, return_aux):
    pc, pf, cam, dirs, ids = inputs
    return render_rays(params_to_torch(pc, "cpu"), params_to_torch(pf, "cpu"),
                       torch.from_numpy(cam.position), torch.from_numpy(dirs), cam.near,
                       cam.far, random.key(seed // 2, "cpu"),
                       RenderConfig(n_coarse=8, n_fine=n_fine, impl=impl),
                       ray_ids=torch.from_numpy(ids.astype(np.int64)), return_aux=return_aux)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n_fine", [16, 0], ids=["two_pass", "single_pass"])
def test_render_rays_matches_jax(golden, n_fine, impl):
    """Same weights, rays, key and per-ray ids: the port's render equals
    the JAX render (f32, atol 1e-5). The JAX side runs its XLA oracle; the
    port's "pallas" impl runs the kernel's plain version on the CPU."""
    inputs, want = jax_case(n_fine, 8, 14, False)
    got = port_case(inputs, n_fine, 14, impl, False)
    assert got.shape == (64, 3)
    assert float(np.abs(np.asarray(want) - 1.0).max()) > 0.05   # not just background
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("n_fine", [16, 0], ids=["two_pass", "single_pass"])
def test_render_rays_aux_matches_jax(golden, n_fine, impl):
    """return_aux: the fine image and every aux entry of the JAX render
    (the coarse pass then runs the full network in both packages)."""
    inputs, (want, want_aux) = jax_case(n_fine, 6, 20, True)
    got, aux = port_case(inputs, n_fine, 20, impl, True)
    assert sorted(aux) == sorted(want_aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert float(np.abs(np.asarray(want_aux["rgb_coarse"]) - 1.0).max()) > 0.05
    for name, value in want_aux.items():
        atol = 1e-4 if name == "depth" else 1e-5      # depth sums t ~ 4 times weights
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(value), atol=atol, rtol=0,
                                   err_msg=name)


def test_render_image_chunk_invariant(golden):
    cam = camera_from_golden(golden)
    pc, pf = np_params(SMALL, 12), np_params(SMALL, 13)
    imgs = [render_image(pc, pf, cam, 12, 10, random.key(3, "cpu"),
                         RenderConfig(n_coarse=8, n_fine=8, ray_chunk=chunk))
            for chunk in (32, 120)]
    assert torch.equal(imgs[0], imgs[1])


def test_render_image_lego_vs_committed_golden(golden):
    """The kernel path (its plain version on the CPU) renders the JAX
    package's committed 64x64 golden (f32, key 0) above 45 dB."""
    coarse, fine = (load_nerf_params(LEGO / n) for n in ("coarse", "fine"))
    img = render_image(coarse, fine, camera_from_golden(golden), 64, 64, random.key(0, "cpu"),
                       RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024, impl="pallas"))
    assert img.shape == (64, 64, 3) and img.dtype == torch.float32
    score = psnr(img.numpy(), load_ppm(REPO / "tests" / "goldens" / "lego_64x64_16c32f_key0.ppm"))
    assert score > 45.0, f"PSNR vs committed golden too low: {score:.2f} dB"


@pytest.mark.parametrize("change, match", [
    (dict(impl="int8"), "item 12"),
])
def test_unserved_config_raises(golden, change, match):
    pc = params_to_torch(np_params(SMALL, 14), "cpu")
    with pytest.raises(NotImplementedError, match=match):
        render_rays(pc, pc, torch.zeros(3), torch.ones(4, 3) / 3 ** 0.5, 2.0, 6.0,
                    random.key(0, "cpu"), RenderConfig(n_coarse=4, n_fine=4, **change))


def test_unserved_checkpoint_raises():
    """Serving a training checkpoint waits for item 10, and the refusal
    leaves the renderer's state untouched."""
    from nerf_rs_tpu_torch import api

    before = dict(api._state)
    with pytest.raises(NotImplementedError, match="item 10"):
        api.init_renderer(checkpoint="step_00000001", device="cpu")
    assert api._state == before


@pytest.mark.parametrize("nc, nf", [(2, 8), (8, 0), (1024, 1025)])
def test_unserved_resample_counts_raise(nc, nf):
    """Sample counts outside the K3 kernel's envelope raise, on the render
    path too: no quiet switch to the plain chain."""
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, supported

    assert not supported(nc, nf)
    with pytest.raises(NotImplementedError, match="sampling_impl='xla'"):
        fused_resample(torch.zeros(4, nc), torch.zeros(4, nc), torch.zeros(4, nf), 6.0)
    if nf > 0:
        pc = params_to_torch(np_params(SMALL, 16), "cpu")
        with pytest.raises(NotImplementedError, match="sampling_impl='xla'"):
            render_rays(pc, pc, torch.zeros(3), torch.ones(4, 3) / 3 ** 0.5, 2.0, 6.0,
                        random.key(0, "cpu"),
                        RenderConfig(n_coarse=nc, n_fine=nf, sampling_impl="pallas"))


def test_package_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, nerf_rs_tpu_torch\n"
        "for m in pkgutil.walk_packages(nerf_rs_tpu_torch.__path__, 'nerf_rs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'nerf_rs_tpu.'))\n"
        "             or k == 'nerf_rs_tpu')\n"
        "assert not bad, bad\n"
        "walked = {'nerf_rs_tpu_torch.models.hashgrid', 'nerf_rs_tpu_torch.ops.kernels.hash_encode'}\n"
        "assert walked <= set(sys.modules), walked - set(sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_render_cpu_writes_ppm(tmp_path, capsys):
    out = tmp_path / "frame.ppm"
    rc = cli_main(["render", "--device", "cpu", "--width", "8", "--height", "8",
                   "--coarse-samples", "8", "--fine-samples", "8", "--ray-chunk", "16",
                   "-o", str(out)])
    assert rc == 0
    img = load_ppm(out)
    assert img.shape == (8, 8, 3)
    assert "Wrote" in capsys.readouterr().out
