"""PyTorch port, fused resampler K3: ``ops.kernels.resample.fused_resample``
(its plain version on the CPU) against the JAX package's Pallas kernel (in
interpret mode, as tests/test_resample.py runs it), the render's K3 branch
against JAX ``render_rays(sampling_impl="pallas")``, and the coarse samples'
re-attached gradients."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nerf_rs_tpu.accel import OccupancyGrid as JaxGrid
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.ops.kernels.resample import fused_resample as jax_fused_resample
from nerf_rs_tpu.ops.rays import camera_rays as jax_camera_rays
from nerf_rs_tpu.render import render_rays as jax_render_rays
from nerf_rs_tpu_torch.accel import grid_from_numpy
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.resample import (
    fused_resample,
    fused_resample_reference,
    supported,
)
from nerf_rs_tpu_torch.ops.sampling import importance_samples, merge_samples
from nerf_rs_tpu_torch.ops.volume import compute_weights
from nerf_rs_tpu_torch.render import _reattach_coarse_grads, render_rays

torch.set_num_threads(1)

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
# tests/test_resample.py's bars: kernel against the plain chain, rows with
# mass in every bin (the scans run in other orders: a few ulps of the CDF).
ATOL, RTOL = 5e-5, 1e-5
# ... and against the plain sampling chain through a whole render.
RENDER_ATOL = 2e-3


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    out["alpha"]["bias"] += np.float32(2.0)     # a dense field: PDFs far from uniform
    return out


def inputs(n, seed=0, spiky=False, nc=64, nf=128):
    """tests/test_resample.py's rows: jittered t over [2, 6], sigma with
    mass in every bin (or saturating past 5/8 of the ray), uniforms."""
    rng = np.random.default_rng(seed)
    u01 = rng.uniform(size=(n, nc)).astype(np.float32)
    t_c = 2.0 + (np.arange(nc, dtype=np.float32) + u01) * np.float32(4.0 / nc)
    sigma = rng.uniform(0, 30.0 if spiky else 2.0, size=(n, nc)).astype(np.float32)
    if spiky:
        sigma[:, (nc * 5) // 8:] = 100.0        # the T < 1e-4 early-out
    u = rng.uniform(size=(n, nf)).astype(np.float32)
    return t_c.astype(np.float32), sigma, u


@functools.lru_cache(maxsize=None)
def jax_resample(nc, nf, seed, spiky, per_ray):
    t_c, sigma, u = inputs(96, seed, spiky, nc, nf)
    far = (np.random.default_rng(7).uniform(5.0, 6.0, size=(96, 1)).astype(np.float32)
           if per_ray else np.float32(6.0))
    out = jax_fused_resample(jnp.asarray(t_c), jnp.asarray(sigma), jnp.asarray(u),
                             jnp.asarray(far))
    return (t_c, sigma, u, far), np.asarray(out)


def port_resample(t_c, sigma, u, far):
    far = torch.from_numpy(far) if isinstance(far, np.ndarray) and far.ndim else float(far)
    return fused_resample(torch.from_numpy(t_c), torch.from_numpy(sigma), torch.from_numpy(u), far)


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar_far", "per_ray_far"])
@pytest.mark.parametrize("nc, nf", [(64, 128), (32, 64)])
def test_fused_resample_matches_jax(nc, nf, per_ray):
    args, want = jax_resample(nc, nf, 0, False, per_ray)
    got = port_resample(*args)
    assert got.shape == (96, nc + nf) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_resample_saturated_tail():
    """Saturating densities (the early-out active): scan-order noise may
    move a uniform across a bin boundary — JAX's tail bars."""
    args, want = jax_resample(64, 128, 1, True, False)
    err = np.abs(port_resample(*args).numpy() - want)
    assert (err > 1e-4).mean() < 0.01
    assert err.max() < 0.05


def test_fused_resample_empty_batch():
    out = fused_resample(torch.zeros(0, 64), torch.zeros(0, 64), torch.zeros(0, 128), 6.0)
    assert out.shape == (0, 192)


@pytest.mark.parametrize("nc, nf", [(64, 128), (32, 64), (5, 3)])
def test_fused_resample_sorted_in_range_and_a_merge(nc, nf):
    """Rows come out sorted, inside [near, far], and hold every coarse t."""
    t_c, sigma, u = inputs(64, 2, nc=nc, nf=nf)
    out = port_resample(t_c, sigma, u, np.float32(6.0)).numpy()
    assert (np.diff(out, axis=-1) >= 0).all()
    assert (out >= 2.0 - 1e-5).all() and (out <= 6.0 + 1e-5).all()
    for row, tc in zip(out, t_c):
        assert np.isin(tc, row).all()


def test_plain_version_is_the_render_chain():
    """The plain version, fed the uniforms of a key, equals the render's
    plain chain (compute_weights -> importance_samples -> merge) bit for
    bit; a one-value far equals the scalar."""
    t_c, sigma, _ = inputs(32, 3)
    t_c, sigma = torch.from_numpy(t_c), torch.from_numpy(sigma)
    keys = random.fold_in(random.key(5, "cpu"), torch.arange(32))
    u = random.uniform(keys, (32, 128))
    got = fused_resample_reference(t_c, sigma, u, 6.0)
    w = compute_weights(sigma, t_c, 6.0)
    want = merge_samples(t_c, importance_samples(keys, t_c, w, 128))
    assert torch.equal(got, want)
    assert torch.equal(fused_resample(t_c, sigma, u, torch.tensor([6.0])), got)


def test_supported_envelope():
    """The port's own limits, not the TPU's power-of-two lane rule."""
    for nc, nf in [(64, 128), (32, 64), (64, 256), (48, 96), (3, 1), (1024, 1024)]:
        assert supported(nc, nf), (nc, nf)
    for nc, nf in [(2, 8), (64, 0), (1024, 1025)]:
        assert not supported(nc, nf), (nc, nf)


def test_fused_resample_refuses_gradients():
    t_c, sigma, u = (torch.from_numpy(x) for x in inputs(4, 4))
    with pytest.raises(ValueError, match="forward only"):
        fused_resample(t_c.requires_grad_(), sigma, u, 6.0)


def _sphere_occ(res=16, radius=0.9):
    c = -2.0 + (np.arange(res) + 0.5) * (4.0 / res)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    return (gx ** 2 + gy ** 2 + gz ** 2) < radius ** 2


@functools.lru_cache(maxsize=None)
def jax_k3_render(grid_kind, side=4):
    """JAX render_rays through its Pallas K3 (interpret mode) on side x
    side golden-camera rays with the SMALL nets -> (inputs, output)."""
    golden = load_golden(LEGO / "tf_reference_samples.json")
    pc, pf = np_params(SMALL, 30), np_params(SMALL, 31)
    _, dirs = jax_camera_rays(jax_camera_from_golden(golden), side, side)
    dirs = np.array(dirs).reshape(-1, 3)
    ids = np.arange(side * side, dtype=np.int32) + 77
    cam = camera_from_golden(golden)
    cfg = dict(n_coarse=32, n_fine=64, sampling_impl="pallas")
    jgrid = None
    if grid_kind == "aabb_probes":
        cfg.update(accel_sample_aabb=True, accel_aabb_probes=16)
    if grid_kind:
        occ = _sphere_occ()
        jgrid = JaxGrid(occ=jnp.asarray(occ), aabb_min=jnp.full((3,), -2.0, jnp.float32),
                        aabb_max=jnp.full((3,), 2.0, jnp.float32))
    want = jax_render_rays(
        jax.tree_util.tree_map(jnp.asarray, pc), jax.tree_util.tree_map(jnp.asarray, pf),
        jnp.asarray(cam.position), jnp.asarray(dirs), cam.near, cam.far, jax.random.key(4),
        JaxRenderConfig(**cfg), ray_ids=jnp.asarray(ids), grid=jgrid)
    return (pc, pf, cam, dirs, ids, cfg), np.asarray(want)


@pytest.mark.parametrize("grid_kind", [None, "mask", "aabb_probes"],
                         ids=["no_grid", "grid_mask_only", "grid_aabb_probes_per_ray_far"])
def test_render_rays_k3_matches_jax(grid_kind):
    """The port's render with sampling_impl="pallas" against JAX's, with
    and without a grid; "aabb_probes" places samples in each ray's probed
    range, so K3 gets a per-ray far."""
    (pc, pf, cam, dirs, ids, cfg), want = jax_k3_render(grid_kind)
    grid = grid_from_numpy(_sphere_occ(), -2.0, 2.0, "cpu") if grid_kind else None
    got = render_rays(params_to_torch(pc, "cpu"), params_to_torch(pf, "cpu"),
                      torch.from_numpy(cam.position), torch.from_numpy(dirs), cam.near, cam.far,
                      random.key(4, "cpu"), RenderConfig(**cfg),
                      ray_ids=torch.from_numpy(ids.astype(np.int64)), grid=grid)
    assert float(np.abs(want - 1.0).max()) > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL, rtol=0)


def test_render_rays_k3_gradient_parity_with_jax():
    """d(sum rgb^2)/d(far) through the K3 path — the stratified coarse
    samples move with far, and _reattach_coarse_grads routes their
    gradients through the kernel's merge — against jax.grad of JAX's K3
    path (tests/test_resample.py's bar), SMALL nets, 4x4 rays."""
    golden = load_golden(LEGO / "tf_reference_samples.json")
    pc, pf = np_params(SMALL, 40), np_params(SMALL, 41)
    jcam = jax_camera_from_golden(golden)
    _, dirs = jax_camera_rays(jcam, 4, 4)
    dirs = np.array(dirs).reshape(-1, 3)
    cam = camera_from_golden(golden)
    cfg = dict(n_coarse=32, n_fine=64, sampling_impl="pallas")
    jpc, jpf = (jax.tree_util.tree_map(jnp.asarray, p) for p in (pc, pf))

    def jax_loss(far):
        rgb = jax_render_rays(jpc, jpf, jnp.asarray(cam.position), jnp.asarray(dirs),
                              cam.near, far, jax.random.key(3), JaxRenderConfig(**cfg))
        return jnp.sum(rgb ** 2)

    want = float(jax.grad(jax_loss)(jnp.float32(cam.far)))
    far = torch.tensor(float(cam.far), requires_grad=True)
    rgb = render_rays(params_to_torch(pc, "cpu"), params_to_torch(pf, "cpu"),
                      torch.from_numpy(cam.position), torch.from_numpy(dirs), cam.near, far,
                      random.key(3, "cpu"), RenderConfig(**cfg))
    (rgb ** 2).sum().backward()
    got = float(far.grad)
    assert np.isfinite(got) and abs(got) > 0
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-4)


def test_reattach_backward_equals_sort_autograd():
    """The re-attach's backward routes each coarse sample the gradient
    torch.sort's autograd gives it, exactly, on rows of distinct values."""
    rng = np.random.default_rng(9)
    t_c = torch.from_numpy(np.sort(rng.uniform(2, 6, (16, 32)), -1).astype(np.float32))
    t_x = torch.from_numpy(rng.uniform(2, 6, (16, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(16, 96)).astype(np.float32))
    a = t_c.clone().requires_grad_()
    merge_samples(a, t_x).backward(g)
    b = t_c.clone().requires_grad_()
    t_f = merge_samples(b.detach(), t_x)
    out = _reattach_coarse_grads(t_f, b)
    assert torch.equal(out, t_f)
    out.backward(g)
    assert torch.equal(a.grad, b.grad)


# --- K3's merge (csrc/resample.cu), emulated on the CPU with the warp's
# lanes as a tensor axis.

LANES = torch.arange(32)


def lane_values(k):
    """K: values a lane, the smallest power of two with 32 K >= each of the
    counts ``k``."""
    per_lane = 1
    while any(32 * per_lane < c for c in k):
        per_lane *= 2
    return per_lane


def registers(x, per_lane):
    """(rays, n) -> (rays, 32 lanes, K): sample k 32 + lane in register k
    of its lane, +inf past n."""
    rays, n = x.shape
    v = torch.full((rays, 32 * per_lane), float("inf"))
    v[:, :n] = x
    return v.reshape(rays, per_lane, 32).transpose(1, 2).contiguous()


def warp_sort(v):
    """The kernel's bitonic network on (rays, 32, K): element l K + k in
    register k of lane l; distances below K exchange two registers of a
    lane, distances from K up register k of lanes l and l ^ (j / K)."""
    per_lane = v.shape[-1]
    v = v.clone()
    log_n = (32 * per_lane).bit_length() - 1
    for ls in range(1, log_n + 1):
        size = 1 << ls
        for lj in range(ls - 1, -1, -1):
            j = 1 << lj
            if j < per_lane:
                ks = [k for k in range(per_lane) if k ^ j > k]
                ps = [k ^ j for k in ks]
                up = ((LANES[:, None] * per_lane + torch.tensor(ks)) & size) == 0
                a, b = v[..., ks], v[..., ps]
                lo, hi = torch.minimum(a, b), torch.maximum(a, b)
                v[..., ks], v[..., ps] = torch.where(up, lo, hi), torch.where(up, hi, lo)
            else:
                m = j // per_lane
                other = v[:, LANES ^ m, :]
                keep_min = (((LANES * per_lane) & size) == 0) == ((LANES & m) == 0)
                v = torch.where(keep_min[:, None], torch.minimum(v, other),
                                torch.maximum(v, other))
    return v


def ranks(s, x, or_equal):
    """The kernel's branch-free binary search: per row, the count of the
    sorted s below each x (strictly, or <=)."""
    n = s.shape[1]
    count = torch.zeros(x.shape, dtype=torch.int64)
    step = 1 << (n.bit_length() - 1)
    while step:
        probe = count + step
        y = torch.gather(s, 1, (probe - 1).clamp(max=n - 1))
        hit = (probe <= n) & ((y <= x) if or_equal else (y < x))
        count = torch.where(hit, probe, count)
        step >>= 1
    return count


def emulate_rank_merge(t_c, t_f):
    """K3's merge: the fine samples sorted in registers; the coarse row
    sorted the same way only where a row is not sorted; each value to its
    index in its own sorted list plus the other list's count below it (< for
    fine against coarse, <= for coarse against fine), scattered to the row."""
    rays, nc = t_c.shape
    nf = t_f.shape[1]
    per_lane = lane_values((nc, nf))
    fs = warp_sort(registers(t_f, per_lane)).reshape(rays, -1)[:, :nf]
    in_order = (t_c[:, :-1] <= t_c[:, 1:]).all(dim=1, keepdim=True)
    cs = torch.where(in_order, t_c, warp_sort(registers(t_c, per_lane)).reshape(rays, -1)[:, :nc])
    row = torch.full((rays, nc + nf), float("nan"))
    row.scatter_(1, torch.arange(nf) + ranks(cs, fs, or_equal=False), fs)
    row.scatter_(1, torch.arange(nc) + ranks(fs, cs, or_equal=True), cs)
    return row


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(shape=st.sampled_from([(64, 128), (3, 1), (33, 95), (64, 1984), (32, 64), (130, 7)]),
       seed=st.integers(0, 2 ** 31 - 1), pool=st.sampled_from([2, 5, 40, 0]),
       coarse_sorted=st.booleans())
def test_k3_register_sort_and_rank_merge_equal_torch_sort(shape, seed, pool, coarse_sorted):
    """K3's register sort and rank merge, emulated with the lanes as an axis,
    equal torch.sort of the concatenated row bit for bit: rows drawn from a
    few values (repeats and ties across the two lists) or from a continuum,
    the coarse row sorted or not, nf not a multiple of 32."""
    nc, nf = shape
    rng = np.random.default_rng(seed)
    if pool:
        values = rng.uniform(2.0, 6.0, pool).astype(np.float32)
        t_c, t_f = rng.choice(values, (3, nc)), rng.choice(values, (3, nf))
    else:
        t_c, t_f = (rng.uniform(2.0, 6.0, (3, k)).astype(np.float32) for k in (nc, nf))
    if coarse_sorted:
        t_c = np.sort(t_c, axis=1)
    t_c, t_f = torch.from_numpy(t_c), torch.from_numpy(t_f)
    got = emulate_rank_merge(t_c, t_f)
    assert torch.equal(got, torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values)


def bin_search(cdf, u):
    """The kernel's bin lookup: the largest j < n_bins with cdf[j] <= u, by
    steps of decreasing powers of two."""
    n_bins = cdf.shape[1] - 1
    lo = torch.zeros(u.shape, dtype=torch.int64)
    step = 1 << (n_bins - 1).bit_length() - 1 if n_bins > 1 else 0
    while step:
        probe = lo + step
        y = torch.gather(cdf, 1, probe.clamp(max=n_bins - 1))
        lo = torch.where((probe < n_bins) & (y <= u), probe, lo)
        step >>= 1
    return lo


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(nc=st.integers(3, 70), seed=st.integers(0, 2 ** 31 - 1), flat=st.booleans())
def test_k3_bin_search_is_the_plain_versions_lookup(nc, seed, flat):
    """K3's branch-free bin search finds the plain version's bin
    (``inverse_cdf``: searchsorted right, less one, clamped to the bins) on
    CDFs shaped as the kernel builds them (0, running sums over the total,
    1), with plateaus, for uniforms on and between the entries."""
    rng = np.random.default_rng(seed)
    pdf = rng.uniform(0.0, 1.0, (4, nc - 2)).astype(np.float32)
    if flat:
        pdf[rng.uniform(size=pdf.shape) < 0.5] = 0.0
    run = np.cumsum(pdf, axis=1, dtype=np.float32)
    total = np.maximum(run[:, -1:], np.float32(1e-30))
    cdf = np.concatenate([np.zeros((4, 1), np.float32), run[:, :-1] / total,
                          np.ones((4, 1), np.float32)], axis=1).astype(np.float32)
    u = np.concatenate([rng.uniform(size=(4, 16)), cdf[:, rng.integers(0, nc - 1, 8)]],
                       axis=1).astype(np.float32)
    u = np.minimum(u, np.float32(np.nextafter(np.float32(1.0), np.float32(0.0))))
    cdf, u = torch.from_numpy(cdf), torch.from_numpy(u)
    want = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, nc - 3)
    assert torch.equal(bin_search(cdf, u), want)
