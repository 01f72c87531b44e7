"""PyTorch port, MLP backward: the gradients of the port's fused MLP on the
CPU (the backward kernel's plain version, through the autograd function)
against ``jax.grad`` of the JAX package's fused MLP (its Pallas backward
kernel in interpret mode, as tests/test_fused_mlp.py runs it) and against
torch autograd of the port's own oracle; the packed gradient layout.

The CUDA kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes, nerf_mlp
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    pack_params,
    unpack_grads,
)

torch.set_num_threads(1)

SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
COLOR = ("bottleneck", "viewdirs", "rgb")   # layers only the color branch uses
# f32 against JAX's kernel and against autograd of the oracle: the same
# function with sums in another order (tests/test_fused_mlp.py's bars).
ATOL, RTOL = 1e-6, 1e-4


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def np_rays(rays, samples, seed):
    """Points (rays, samples, 3), one unit dir per ray (rays, 1, 3), and
    cotangents for rgb and sigma."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(rays, samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_rgb = rng.normal(size=(rays, samples, 3)).astype(np.float32)
    g_sig = rng.normal(size=(rays, samples)).astype(np.float32) * 1e-2
    return pts, dirs, g_rgb, g_sig


def torch_leaves(params):
    return {layer: {part: torch.tensor(a, requires_grad=True) for part, a in p.items()}
            for layer, p in params.items()}


@pytest.fixture(scope="module")
def small():
    return np_params(SMALL, 0)


@pytest.mark.parametrize("rays, samples", [(4, 32), (5, 40)], ids=["n128", "n200_ragged"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_grads_match_jax_fused_kernel(small, rays, samples, sigma_only):
    """Parameter, point and per-ray dir gradients of sum(g_rgb * rgb +
    g_sigma * sigma) against jax.grad of the JAX kernel; n = 200 is not a
    multiple of its 128-sample tile. With sigma_only the rgb cotangent
    gives the color branch no gradient in either package."""
    pts, dirs, g_rgb, g_sig = np_rays(rays, samples, 1)

    def jax_loss(p, x, d):
        rgb, sig = jax_fused_nerf_mlp(p, x, d, sigma_only=sigma_only)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sig * g_sig)

    want_p, want_x, want_d = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, small), jnp.asarray(pts), jnp.asarray(dirs))
    leaves = torch_leaves(small)
    x = torch.tensor(pts, requires_grad=True)
    d = torch.tensor(dirs, requires_grad=True)
    rgb, sig = fused_nerf_mlp(leaves, x, d, sigma_only=sigma_only)
    (torch.sum(rgb * torch.from_numpy(g_rgb)) + torch.sum(sig * torch.from_numpy(g_sig))).backward()
    for layer, parts in leaves.items():
        for part, t in parts.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_p[layer][part]),
                                       atol=ATOL, rtol=RTOL, err_msg=f"{layer}/{part}")
            if sigma_only and layer in COLOR:
                assert not t.grad.any(), f"{layer}/{part}"
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), atol=ATOL, rtol=RTOL)
    assert d.grad.shape == dirs.shape
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_d), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("as_module", [False, True], ids=["tree", "module"])
def test_fused_grads_reach_every_parameter_on_cpu(small, as_module):
    """Every parameter gets a gradient through the fused path on the CPU,
    equal to torch autograd of the oracle (its pack once dropped them)."""
    pts, dirs, _, _ = np_rays(6, 20, 2)
    grads = []
    for fn in (fused_nerf_mlp, nerf_mlp):
        net = NerfMLP(small, requires_grad=True) if as_module else torch_leaves(small)
        rgb, sig = fn(net, torch.from_numpy(pts), torch.from_numpy(dirs))
        (rgb.mean() + 1e-3 * sig.mean()).backward()
        tree = net.tree() if as_module else net
        grads.append({(layer, part): t.grad for layer, p in tree.items() for part, t in p.items()})
    for name, want in grads[1].items():
        got = grads[0][name]
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL, err_msg=str(name))


def test_input_grads_only_when_asked(small, monkeypatch):
    """Points' and dirs' gradients are computed only when they need them;
    the parameters' always come back."""
    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm

    seen = []
    real = fm.fused_nerf_mlp_backward_reference

    def spy(*args, **kw):
        seen.append(kw["input_grads"])
        return real(*args, **kw)

    monkeypatch.setattr(fm, "fused_nerf_mlp_backward_reference", spy)
    pts, dirs, _, _ = np_rays(2, 16, 3)
    net = NerfMLP(small, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, torch.from_numpy(pts), torch.from_numpy(dirs))
    (rgb.sum() + sig.sum()).backward()
    x = torch.tensor(pts, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, x, torch.from_numpy(dirs))
    (rgb.sum() + sig.sum()).backward()
    assert seen == [False, True]
    assert x.grad is not None and all(p.grad is not None for p in net.parameters())


def test_changed_parameter_before_backward_raises(small):
    """The autograd function saves its parameter tensors: an in-place
    change between forward and backward raises, as autograd does."""
    pts, dirs, _, _ = np_rays(2, 8, 4)
    net = NerfMLP(small, requires_grad=True)
    rgb, sig = fused_nerf_mlp(net, torch.from_numpy(pts), torch.from_numpy(dirs))
    with torch.no_grad():
        net.weights["dense1_kernel"].mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        (rgb.sum() + sig.sum()).backward()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_wrapper_on_cpu_is_the_reference_and_counts_no_launch(small, dtype):
    pts, dirs, g_rgb, g_sig = np_rays(3, 24, 5)
    args = (params_to_torch(small, "cpu"), torch.from_numpy(pts), torch.from_numpy(dirs),
            torch.from_numpy(g_rgb), torch.from_numpy(g_sig))
    before = fused_nerf_mlp_backward.launches
    got = fused_nerf_mlp_backward(*args, dtype=dtype)
    want = fused_nerf_mlp_backward_reference(*args, dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_nerf_mlp_backward.launches == before
    assert got[0].dtype == torch.float32 and got[0].shape == pack_params(args[0], dtype).weights.shape
    assert got[2].shape == pts.shape and got[3].shape == pts.shape


@pytest.mark.parametrize("arch", [SMALL, ArchConfig(), ArchConfig(width=100, v_width=36, depth=3,
                                                                    skip_at=5)],
                         ids=["small", "canonical", "unaligned_noskip"])
def test_unpack_grads_inverts_pack(arch):
    """unpack_grads of a pack's own weights and biases gives the param
    tree back: every leaf lands where pack_params took it from."""
    params = params_to_torch(np_params(arch, 6), "cpu")
    pk = pack_params(params, "float32")
    tree = unpack_grads(pk, pk.weights, pk.biases)
    assert tree.keys() == params.keys()
    for layer, p in params.items():
        for part, t in p.items():
            assert torch.equal(tree[layer][part], t), f"{layer}/{part}"


def test_transposed_pack_holds_every_product_segment(small):
    """weights_t holds each segment but the heads transposed, at layout_t's
    offsets, in the pack's dtype."""
    params = params_to_torch(small, "cpu")
    for dtype in ("float32", "bfloat16"):
        pk = pack_params(params, dtype)
        assert pk.weights_t.dtype == pk.weights.dtype
        names = [f"dense{i}" for i in range(SMALL.depth)] + ["dense3_enc"]
        offsets = list(pk.layout_t[:SMALL.depth]) + [pk.layout_t[16 + 3]]
        names += ["bottleneck", "viewdirs", "viewdirs_dir"]
        offsets += list(pk.layout_t[32:35])
        for name, off in zip(names, offsets):
            _, k, ld = pk.segments[name]
            got = pk.weights_t[off:off + k * ld].view(ld, k).to(torch.float32)
            assert torch.equal(got, pk.mat(name).t()), (dtype, name)
        assert (pk.layout_t[SMALL.depth:16] == -1).all()
