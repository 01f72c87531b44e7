"""PyTorch port, occupancy-grid acceleration: the grid's geometry, build
and compaction against ``nerf_rs_tpu/accel.py`` on the same numpy grids,
and the accelerated image render (every ``accel_compact`` mode, ray
packing, box placement, strided probes, K3) against JAX ``render_image``."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_rs_tpu.accel as jax_accel
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.ops.rays import camera_rays as jax_camera_rays
from nerf_rs_tpu.render import _image_ray_ranges as jax_image_ray_ranges
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu.render import render_image_aux as jax_render_image_aux
from nerf_rs_tpu_torch import accel
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.models.mlp import arch_shapes, nerf_mlp
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import camera_rays
from nerf_rs_tpu_torch.render import _image_ray_ranges, render_image, render_image_aux

torch.set_num_threads(1)

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
GOLDEN = load_golden(LEGO / "tf_reference_samples.json")
CAM = camera_from_golden(GOLDEN)
JCAM = jax_camera_from_golden(GOLDEN)
ATOL = 1e-5              # f32, the plain sampling chain on both sides
K3_ATOL = 2e-3           # K3 against JAX's K3: scan orders differ (tests/test_resample.py)
BASE = dict(n_coarse=8, n_fine=16, ray_chunk=48)
SIDE = 12


def np_params(arch, seed, bias=2.0):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    out["alpha"]["bias"] += np.float32(bias)
    return out


def occupancy(kind, res=16):
    """Numpy grids over the box (-2, 2)^3: a ball, an off-center slab, and
    the empty and full grids."""
    c = -2.0 + (np.arange(res) + 0.5) * (4.0 / res)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    return {"ball": gx ** 2 + gy ** 2 + gz ** 2 < 0.6 ** 2,
            "slab": (np.abs(gx - 0.6) < 0.4) & (gy > -1.0) & (gz < 0.5),
            "empty": np.zeros((res,) * 3, bool),
            "full": np.ones((res,) * 3, bool)}[kind]


def both_grids(occ):
    jg = jax_accel.OccupancyGrid(occ=jnp.asarray(occ), aabb_min=jnp.full((3,), -2.0, jnp.float32),
                                 aabb_max=jnp.full((3,), 2.0, jnp.float32))
    return jg, accel.grid_from_numpy(occ, -2.0, 2.0, "cpu")


def image_dirs(h, w):
    _, d = camera_rays(CAM, h, w, "cpu")
    return d


def assert_ranges(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["ball", "slab", "empty", "full"])
def test_grid_geometry_matches_jax(kind):
    """query_occupancy (booleans equal), occupied_aabb, ray_aabb_range and
    ray_occupied_range (to 1e-6) on one numpy grid."""
    jg, g = both_grids(occupancy(kind))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.5, 2.5, size=(7, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(accel.query_occupancy(g, torch.from_numpy(pts)).numpy(),
                                  np.asarray(jax_accel.query_occupancy(jg, jnp.asarray(pts))))
    assert_ranges(accel.occupied_aabb(g), jax_accel.occupied_aabb(jg))
    dirs = image_dirs(9, 7).reshape(-1, 3)
    o = torch.from_numpy(CAM.position)
    jargs = (jnp.asarray(CAM.position), jnp.asarray(dirs.numpy()), CAM.near, CAM.far)
    assert_ranges(accel.ray_aabb_range(g, o, dirs, CAM.near, CAM.far),
                  jax_accel.ray_aabb_range(jg, *jargs))
    assert_ranges(accel.ray_occupied_range(g, o, dirs, CAM.near, CAM.far, probes=24),
                  jax_accel.ray_occupied_range(jg, *jargs, probes=24))


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("kind", ["ball", "slab"])
def test_strided_ray_ranges_match_jax(kind, stride):
    """The strided probe ranges and their 3x3 min/max pools, on a 13x10
    frame whose edges cut the stride blocks (the pools' -inf padding at
    the borders)."""
    jg, g = both_grids(occupancy(kind))
    d = image_dirs(13, 10)
    got = accel.strided_ray_ranges(g, torch.from_numpy(CAM.position), d, CAM.near, CAM.far,
                                   stride=stride, probes=16)
    want = jax_accel.strided_ray_ranges(jg, jnp.asarray(CAM.position), jnp.asarray(d.numpy()),
                                        CAM.near, CAM.far, stride=stride, probes=16)
    assert_ranges(got, want)
    assert (got[1] >= got[0]).all() and bool((got[1] > got[0]).any())


def test_density_grid_and_scene_grid_match_jax():
    """The sweep at res 16 through the oracle MLP: sigma to 1e-5 relative;
    the thresholded, dilated union grid equal except where a cell's 3^3
    neighbourhood holds a sigma within 1e-4 of the threshold."""
    pc, pf = np_params(SMALL, 50, bias=0.0), np_params(SMALL, 51, bias=0.0)

    def jfn(p, x, d):
        return jax_nerf_mlp(p, x, d)

    def tfn(p, x, d):
        return nerf_mlp(p, x, d)

    jpc, jpf = (jax.tree_util.tree_map(jnp.asarray, p) for p in (pc, pf))
    kw = dict(resolution=16, aabb=(-2.0, 2.0), chunk=1000)
    sig_j = [np.asarray(jax_accel.density_grid(p, mlp_fn=jfn, **kw)) for p in (jpc, jpf)]
    sig_t = [accel.density_grid(params_to_torch(p, "cpu"), mlp_fn=tfn, **kw).numpy()
             for p in (pc, pf)]
    for a, b in zip(sig_t, sig_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
    thr = float(np.quantile(np.maximum(*sig_j), 0.97))
    grid_j = jax_accel.build_scene_grid(jpc, jpf, mlp_fn=jfn, sigma_threshold=thr, **kw)
    grid_t = accel.build_scene_grid(params_to_torch(pc, "cpu"), params_to_torch(pf, "cpu"),
                                    mlp_fn=tfn, sigma_threshold=thr, **kw)
    near = np.zeros((16,) * 3, bool)
    for s in sig_j:
        near |= np.abs(s - thr) < 1e-4
    near = torch.nn.functional.max_pool3d(torch.from_numpy(near)[None, None].float(), 3, 1,
                                          1)[0, 0].numpy() > 0
    occ_j = np.asarray(grid_j.occ)
    assert 0.05 < occ_j.mean() < 0.95
    np.testing.assert_array_equal(grid_t.occ.numpy()[~near], occ_j[~near])
    np.testing.assert_array_equal(grid_t.aabb_min.numpy(), np.asarray(grid_j.aabb_min))


@pytest.mark.parametrize("impl", ["scatter", "gather"])
@pytest.mark.parametrize("capacity", [64, 16], ids=["fits", "overflows"])
def test_compact_apply_matches_jax(impl, capacity):
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(64, 6)).astype(np.float32)
    mask = rng.uniform(size=64) < 0.4
    want = jax_accel.compact_apply(lambda b: (b[:, :3] * 2.0, b[:, 3:4] + 1.0),
                                   jnp.asarray(rows), jnp.asarray(mask), capacity, (0.0, -1.0),
                                   impl=impl)
    got = accel.compact_apply(lambda b: (b[:, :3] * 2.0, b[:, 3:4] + 1.0),
                              torch.from_numpy(rows), torch.from_numpy(mask), capacity,
                              (0.0, -1.0), impl=impl)
    assert int(got[2]) == int(want[2]) == int(mask.sum())
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if capacity < mask.sum():
        assert (got[1].numpy() == -1.0).sum() > (~mask).sum()    # overflow rows take the fill


def test_capacity_estimates_match_jax():
    """suggest_capacities (geometry only), calibrate_capacities (one
    instrumented render at capacity 1) and capacities_from_occupancy."""
    jg, g = both_grids(occupancy("ball"))
    cfg = dict(BASE, accel_compact="scatter")
    got = accel.suggest_capacities(g, CAM, SIDE, SIDE, RenderConfig(**cfg))
    want = jax_accel.suggest_capacities(jg, JCAM, SIDE, SIDE, JaxRenderConfig(**cfg))
    for name in ("accel_coarse_capacity", "accel_fine_capacity"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6)
    pc, pf = np_params(SMALL, 60), np_params(SMALL, 61)
    got = accel.calibrate_capacities(params_to_torch(pc, "cpu"), params_to_torch(pf, "cpu"), g,
                                     CAM, SIDE, SIDE, random.key(1, "cpu"), RenderConfig(**cfg))
    want = jax_accel.calibrate_capacities(jax.tree_util.tree_map(jnp.asarray, pc),
                                          jax.tree_util.tree_map(jnp.asarray, pf), jg, JCAM,
                                          SIDE, SIDE, jax.random.key(1), JaxRenderConfig(**cfg))
    for name in ("accel_coarse_capacity", "accel_fine_capacity"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6)
        assert 0.0 < getattr(got, name) < 1.0
    for frac in (0.01, 0.2, 0.7):
        assert (accel.capacities_from_occupancy(frac, RenderConfig(**cfg))
                == jax_accel.capacities_from_occupancy(frac, JaxRenderConfig(**cfg)))


# (name, config changes, tolerance) for render_image with the ball grid.
RENDER_CASES = [
    *[(f"{mode}{'_cull' if cull else ''}", dict(accel_compact=mode, accel_cull_rays=cull), ATOL)
      for mode in ("off", "none", "scatter", "gather") for cull in (False, True)],
    ("aabb_probes_cull", dict(accel_sample_aabb=True, accel_aabb_probes=16,
                              accel_cull_rays=True), ATOL),
    ("off_probes_stride2_cull", dict(accel_compact="off", accel_aabb_probes=16,
                                     accel_range_stride=2, accel_cull_rays=True), ATOL),
    ("k3_off_probes_stride2_cull", dict(n_coarse=32, n_fine=64, sampling_impl="pallas",
                                        accel_compact="off", accel_aabb_probes=16,
                                        accel_range_stride=2, accel_cull_rays=True), K3_ATOL),
    ("k3_aabb_probes_cull", dict(n_coarse=32, n_fine=64, sampling_impl="pallas",
                                 accel_sample_aabb=True, accel_aabb_probes=16,
                                 accel_cull_rays=True), K3_ATOL),
]


@functools.lru_cache(maxsize=None)
def nets():
    """SMALL nets with a dense field (alpha bias +4): the fine samples move
    with the last bits of the coarse weights, and a sparser field turns
    that into up to 6e-4 of color between the two packages' f32 renders
    (measured on the CPU; bias +4: under 7e-6)."""
    pc, pf = np_params(SMALL, 70, bias=4.0), np_params(SMALL, 71, bias=4.0)
    return pc, pf, tuple(jax.tree_util.tree_map(jnp.asarray, p) for p in (pc, pf))


def port_render(cfg, kind="ball", key=5, **kw):
    pc, pf, _ = nets()
    _, g = both_grids(occupancy(kind))
    return render_image(pc, pf, CAM, SIDE, SIDE, random.key(key, "cpu"), RenderConfig(**cfg),
                        grid=g, **kw)


def ray_ranges(cfg, kind="ball"):
    """Both packages' image-level ranges (JAX's jitted) -> (port (t0, t1),
    JAX (t0, t1)) as (SIDE, SIDE) arrays."""
    jg, g = both_grids(occupancy(kind))
    _, d = camera_rays(CAM, SIDE, SIDE, "cpu")
    port, _, _ = _image_ray_ranges(g, torch.from_numpy(CAM.position), d, torch.tensor(CAM.near),
                                   torch.tensor(CAM.far), RenderConfig(**cfg))
    _, jd = jax_camera_rays(JCAM, SIDE, SIDE)
    jax_r, _, _ = jax_image_ray_ranges(jg, jnp.asarray(CAM.position), jd,
                                       jnp.asarray(CAM.near), jnp.asarray(CAM.far),
                                       JaxRenderConfig(**cfg))
    return ([x.numpy().reshape(SIDE, SIDE) for x in port],
            [np.asarray(x).reshape(SIDE, SIDE) for x in jax_r])


@pytest.mark.parametrize("name, change, tol", RENDER_CASES, ids=[c[0] for c in RENDER_CASES])
def test_render_image_with_grid_matches_jax(name, change, tol):
    """Compared on the rays whose image-level ranges agree to 1e-6 (at
    least 95%): XLA's fused arithmetic moves a probe point by an ulp from
    the eager one, and at a cell boundary that moves a range by a whole
    probe step. With ray packing only the hit rays are compared: JAX also
    renders culled rays up to a multiple of 4 chunks (a compile-cache
    rounding the port leaves out)."""
    cfg = dict(BASE, **change)
    _, _, (jpc, jpf) = nets()
    jg, _ = both_grids(occupancy("ball"))
    want = np.asarray(jax_render_image(jpc, jpf, JCAM, SIDE, SIDE, jax.random.key(5),
                                       JaxRenderConfig(**cfg), grid=jg))
    got = port_render(cfg).numpy()
    assert got.shape == (SIDE, SIDE, 3)
    (t0, t1), (j0, j1) = ray_ranges(cfg)
    rows = (np.abs(t0 - j0) <= 1e-6) & (np.abs(t1 - j1) <= 1e-6)
    assert rows.mean() >= 0.95
    hit = t1 > t0
    assert hit.mean() > 0.05
    if cfg.get("accel_cull_rays"):
        rows &= hit
        if not hit.all():
            assert bool((got[~hit] == 1.0).all(-1).any())          # culled to the background
    assert float(np.abs(want[rows] - 1.0).max()) > 0.05
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=0)


@pytest.mark.parametrize("change", [
    dict(accel_compact="none"),
    dict(accel_compact="off", accel_aabb_probes=16),
    dict(accel_sample_aabb=True, accel_aabb_probes=16),
    dict(n_coarse=32, n_fine=64, sampling_impl="pallas", accel_compact="off",
         accel_aabb_probes=16),
], ids=["mask_only", "off_probes", "aabb_probes", "k3_off_probes"])
def test_packed_equals_unpacked_on_hit_rays(change):
    """Ray packing reorders rays and pads the last chunk with leading hit
    rays: every hit ray is bitwise the unpacked accel render's. A culled
    ray is background, unless it rode along in a rendered chunk: then it
    too is the unpacked render's."""
    cfg = dict(BASE, **change)
    (t0, t1), _ = ray_ranges(cfg)
    hit = torch.from_numpy(t1 > t0)
    assert 0 < int(hit.sum()) < SIDE * SIDE
    unpacked = port_render(cfg)
    packed = port_render(dict(cfg, accel_cull_rays=True))
    assert torch.equal(packed[hit], unpacked[hit])
    white = (packed == 1.0).all(-1)
    assert bool((white | (packed == unpacked).all(-1))[~hit].all())
    assert int(white[~hit].sum()) >= SIDE * SIDE - -(-int(hit.sum()) // 48) * 48


def test_accel_off_hit_rays_equal_the_exact_render():
    """accel_compact="off" masks no sample: packed hit rays are bitwise
    the dense render's (tests/test_accel.py's contract)."""
    cfg = dict(BASE, accel_compact="off", accel_cull_rays=True)
    pc, pf, _ = nets()
    exact = render_image(pc, pf, CAM, SIDE, SIDE, random.key(5, "cpu"), RenderConfig(**BASE))
    (t0, t1), _ = ray_ranges(cfg)
    hit = torch.from_numpy(t1 > t0)
    assert torch.equal(port_render(cfg)[hit], exact[hit])


@pytest.mark.parametrize("kind", ["empty", "full"])
def test_packed_render_at_the_extremes(kind):
    """An empty grid culls every ray to background; a full grid packs every
    ray and matches the unpacked render bitwise."""
    cfg = dict(BASE, accel_cull_rays=True)
    img = port_render(cfg, kind=kind, key=2)
    if kind == "empty":
        assert bool((img == 1.0).all())
    else:
        assert torch.equal(img, port_render(dict(BASE), kind=kind, key=2))


def test_return_live_counts_and_ignores_packing():
    img, (live_c, live_f) = port_render(dict(BASE, accel_compact="scatter", accel_cull_rays=True,
                                             accel_coarse_capacity=1.0, accel_fine_capacity=1.0),
                                        return_live=True)
    assert img.shape == (SIDE, SIDE, 3)
    assert 0 < int(live_c) <= 48 * 8 and 0 < int(live_f) <= 48 * 24


@pytest.mark.parametrize("with_grid", [False, True], ids=["dense", "grid"])
def test_render_image_aux_matches_jax(with_grid):
    """Depth and opacity maps (and the rgb beside them) against JAX."""
    _, _, (jpc, jpf) = nets()
    pc, pf, _ = nets()
    jg, g = both_grids(occupancy("ball"))
    want = jax_render_image_aux(jpc, jpf, JCAM, 8, 8, jax.random.key(6),
                                JaxRenderConfig(**BASE), grid=jg if with_grid else None)
    got = render_image_aux(pc, pf, CAM, 8, 8, random.key(6, "cpu"), RenderConfig(**BASE),
                           grid=g if with_grid else None)
    for name, a, b in zip(("rgb", "depth", "acc"), got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        atol = ATOL
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0, err_msg=name)
    assert float(np.asarray(want[2]).max()) > 0.5
