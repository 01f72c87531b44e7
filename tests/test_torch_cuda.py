"""PyTorch port on the card: the fused MLP kernel against its plain version.

Needs an NVIDIA card and nvcc, and skips elsewhere. Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.weights import load_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_reference
from nerf_rs_tpu_torch.render import render_image

pytestmark = pytest.mark.cuda

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
# Kernel against plain version: f32 differs by summation order only; bf16
# by summation order between bf16 roundings (tests/test_fused_mlp.py's bars).
TOL = {"float32": (1e-4, 1e-3, 1e-4), "bfloat16": (2e-2, 2e-2, 2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def inputs(rays, samples, seed, device):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(rays, samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.from_numpy(pts).to(device), torch.from_numpy(dirs).to(device)


def check(net, pts, dirs, dtype, sigma_only):
    rgb_atol, sig_atol, sig_rtol = TOL[dtype]
    before = fused_nerf_mlp.launches
    rgb, sig = fused_nerf_mlp(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    torch.cuda.synchronize()
    assert fused_nerf_mlp.launches == before + 1
    rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, dirs, dtype=dtype, sigma_only=sigma_only)
    assert rgb.shape == rgb_r.shape and sig.shape == sig_r.shape
    torch.testing.assert_close(rgb, rgb_r, atol=rgb_atol, rtol=0)
    torch.testing.assert_close(sig, sig_r, atol=sig_atol, rtol=sig_rtol)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ArchConfig(width=128, v_width=64, depth=4, skip_at=2),
                                  ArchConfig(width=100, v_width=36, depth=3, skip_at=5)],
                         ids=["small", "unaligned_noskip"])
def test_kernel_matches_plain_ragged(card, arch, dtype, sigma_only):
    """A ragged sample count (37 x 29 = 1073, not a tile multiple), per-ray dirs."""
    net = NerfMLP(np_params(arch, 0), device=card)
    pts, dirs = inputs(37, 29, 1, card)
    check(net, pts, dirs, dtype, sigma_only)
    check(net, pts, dirs.expand(37, 29, 3).contiguous(), dtype, sigma_only)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_kernel_matches_plain_lego(card, net, dtype):
    module = NerfMLP(load_nerf_params(LEGO / net), device=card)
    pts, dirs = inputs(64, 96, 2, card)
    check(module, pts * 0.4, dirs, dtype, net == "coarse")


def test_kernel_refuses_what_it_does_not_take(card):
    net = NerfMLP(np_params(ArchConfig(width=128, v_width=64, depth=4, skip_at=2), 3),
                  device=card)
    pts, dirs = inputs(4, 8, 3, card)
    with pytest.raises(TypeError):
        fused_nerf_mlp(net, pts.double(), dirs)
    with pytest.raises(ValueError, match="contiguous"):
        fused_nerf_mlp(net, pts.transpose(0, 1), dirs.transpose(0, 1))
    with pytest.raises(NotImplementedError, match="item 9"):
        fused_nerf_mlp(net, pts.requires_grad_(), dirs)


def test_render_on_card_matches_cpu(card):
    """A small lego frame through the kernel on the card against the
    plain version on the CPU."""
    cam = camera_from_golden(load_golden(LEGO / "tf_reference_samples.json"))
    coarse, fine = (load_nerf_params(LEGO / n) for n in ("coarse", "fine"))
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=512, impl="pallas")
    before = fused_nerf_mlp.launches
    gpu = render_image(coarse, fine, cam, 32, 32, random.key(0, card), cfg, device=card)
    assert fused_nerf_mlp.launches == before + 2 * 2
    cpu = render_image(coarse, fine, cam, 32, 32, random.key(0, "cpu"), cfg)
    mse = float(((gpu.cpu().double() - cpu.double()) ** 2).mean())
    assert -10 * np.log10(max(mse, 1e-20)) > 60.0
