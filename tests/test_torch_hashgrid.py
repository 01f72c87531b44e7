"""PyTorch port, hash-grid family: the encode's plain version, the field,
its gradients, the render (dense and through a grid) and a training step
against ``nerf_rs_tpu/models/hashgrid.py`` and the JAX package's render and
train, on the same numpy inputs.

Sizes are tests/test_hashgrid.py's TINY: 4 levels of 2^12 rows,
resolutions 4-32, so two levels index directly and two hash. On the CPU
the encode runs its plain version; the kernel is held against it on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import nerf_rs_tpu.accel as jax_accel
from nerf_rs_tpu import train as jax_train
from nerf_rs_tpu.config import HashGridConfig as JaxHashGridConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.models import hashgrid as jax_hg
from nerf_rs_tpu.render import _image_ray_ranges as jax_image_ray_ranges
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu.render import render_rays as jax_render_rays
from nerf_rs_tpu_torch import accel
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import HashGridConfig, RenderConfig, TrainConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.models import hashgrid as hg
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.hash_encode import (
    _Corners,
    fused_hash_encode,
    hash_encode_reference,
    level_constants,
    supported,
)
from nerf_rs_tpu_torch.ops.rays import camera_rays
from nerf_rs_tpu_torch.render import _image_ray_ranges, render_image, render_rays
from nerf_rs_tpu_torch.train import (
    create_train_state,
    split_params,
    train_state_from_numpy,
    train_step,
)

torch.set_num_threads(1)

TINY_KW = dict(levels=4, table_log2=12, res_min=4, res_max=32, width=16, geo_features=7,
               color_width=16, aabb=(-1.0, 1.0))
TINY, JAX_TINY = HashGridConfig(**TINY_KW), JaxHashGridConfig(**TINY_KW)
WIDE_KW = dict(TINY_KW, features=8)      # fewer levels x wider rows: --hash-features 8
LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
GOLDEN = load_golden(LEGO / "tf_reference_samples.json")
CAM, JCAM = camera_from_golden(GOLDEN), jax_camera_from_golden(GOLDEN)
# The CLI's hash-grid recipe (nerf_rs_tpu/cli.py:384-402).
RECIPE = dict(lr_init=1e-2, lr_final=1e-4, adam_eps=1e-15)


def np_tree(kw, seed, table_scale=1.0):
    """A hash-grid param tree of numpy arrays: tables U(-scale, scale),
    Glorot-uniform kernels, biases N(0, 0.1)."""
    cfg = HashGridConfig(**kw)
    rng = np.random.default_rng(seed)
    tree = {"hash_tables": rng.uniform(-table_scale, table_scale,
                                       (cfg.levels, 1 << cfg.table_log2, cfg.features))}
    for name, (d_in, d_out) in hg.layer_shapes(cfg).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        tree[name] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)),
                      "bias": rng.normal(0.0, 0.1, d_out)}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_tree(tree):
    return hg.hashgrid_params_from_numpy(tree, "cpu")


def encode_points(seed, n=299):
    """Random points in and around the box (-1, 1)^3, plus points on every
    level's lattice planes, on the box's faces and corners, outside it, and
    NaN / +-inf coordinates."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-1.3, 1.3, (n, 3))]
    for res in hg.level_resolutions(TINY):
        k = rng.integers(0, res + 1, (16, 3))
        pts.append(-1.0 + 2.0 * k / res)                     # lattice points
    pts.append(np.array([[1.0, -1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, 0.3, -0.2],
                         [5.0, -9.0, 2.0], [-1.5, 0.2, 1.7]]))
    pts.append(np.array([[np.nan, 0.1, 0.2], [np.inf, -0.5, 0.0], [-np.inf, np.nan, np.inf],
                         [0.25, np.nan, -np.inf]]))
    return np.concatenate(pts).astype(np.float32)


def unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kw", [TINY_KW, dict(TINY_KW, levels=1), {},
                                dict(levels=7, res_min=3, res_max=100)],
                         ids=["tiny", "one_level", "paper", "odd"])
def test_level_resolutions_match_jax(kw):
    assert hg.level_resolutions(HashGridConfig(**kw)) == \
        jax_hg.level_resolutions(JaxHashGridConfig(**kw))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encoding_matches_jax(degree):
    dirs = unit(np.random.default_rng(degree), 64)
    got = hg.sh_encoding(torch.from_numpy(dirs), degree).numpy()
    want = np.asarray(jax_hg.sh_encoding(jnp.asarray(dirs), degree))
    assert got.shape == (64, degree ** 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [TINY_KW, WIDE_KW], ids=["tiny", "wide_f8"])
def test_hash_encode_reference_matches_jax_f32(kw):
    """f32, within 1e-6: the same cells, rows and weights, the corners
    summed in the same order."""
    tables = np_tree(kw, 1)["hash_tables"]
    pts = encode_points(2).reshape(-1, 4, 3)               # a batch shape of two dims
    got = hash_encode_reference(torch.from_numpy(tables), torch.from_numpy(pts), TINY)
    want = np.asarray(jax_hg.hash_encode(jnp.asarray(tables), jnp.asarray(pts), JAX_TINY))
    assert got.shape == (*pts.shape[:-1], tables.shape[0] * tables.shape[2])
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [TINY_KW, WIDE_KW], ids=["tiny_packed_pair", "wide_f8"])
def test_hash_encode_reference_matches_jax_bf16(kw):
    """bf16 tables: the port sums in f32 and rounds once; JAX rounds each
    product and partial sum (where XLA keeps them in bf16). Within 2 bf16
    ulps of the largest feature."""
    tables = np_tree(kw, 3)["hash_tables"]
    pts = encode_points(4)
    t16 = torch.from_numpy(tables).to(torch.bfloat16)
    got = hash_encode_reference(t16, torch.from_numpy(pts), TINY)
    want = np.asarray(jax_hg.hash_encode(jnp.asarray(tables).astype(jnp.bfloat16),
                                         jnp.asarray(pts), JAX_TINY), np.float32)
    assert got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * ulp, rtol=0)


def test_fused_hash_encode_on_cpu_is_the_plain_version():
    tables = torch.from_numpy(np_tree(TINY_KW, 5)["hash_tables"])
    pts = torch.from_numpy(encode_points(6))
    before = fused_hash_encode.launches
    assert torch.equal(fused_hash_encode(tables, pts, TINY),
                       hash_encode_reference(tables, pts, TINY))
    assert fused_hash_encode.launches == before            # no kernel on the CPU


def test_unserved_tables_raise():
    pts = torch.zeros(4, 3)
    assert not supported(torch.zeros(4, 16, 2, dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="item 12"):
        fused_hash_encode(torch.zeros(4, 16, 2, dtype=torch.float16), pts, TINY)
    many = HashGridConfig(levels=65, table_log2=4)
    with pytest.raises(NotImplementedError, match="item 12"):
        fused_hash_encode(torch.zeros(65, 16, 2), pts, many)
    with pytest.raises(ValueError, match="levels"):
        fused_hash_encode(torch.zeros(3, 16, 2), pts, TINY)


def field_inputs(seed, rays=6, samples=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (rays, samples, 3)).astype(np.float32)
    dirs = unit(rng, rays).reshape(rays, 1, 3)
    return pts, dirs


@pytest.mark.parametrize("sigma_only", [False, True], ids=["rgb_sigma", "sigma_only"])
def test_hashgrid_mlp_matches_jax(sigma_only):
    tree = np_tree(TINY_KW, 7)
    pts, dirs = field_inputs(8)
    rgb, sigma = hg.hashgrid_mlp(port_tree(tree), torch.from_numpy(pts), torch.from_numpy(dirs),
                                 cfg=TINY, sigma_only=sigma_only)
    want_rgb, want_sigma = jax_hg.hashgrid_mlp(jax_tree(tree), jnp.asarray(pts),
                                               jnp.asarray(dirs), cfg=JAX_TINY,
                                               sigma_only=sigma_only)
    assert rgb.shape == (6, 5, 3) and sigma.shape == (6, 5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), rtol=0, atol=1e-5)
    if sigma_only:
        assert not rgb.any()
    # The module gives the function's values.
    field = hg.HashGridField(tree)
    _, sigma_m = field(torch.from_numpy(pts), torch.from_numpy(dirs), cfg=TINY,
                       sigma_only=sigma_only)
    assert torch.equal(sigma_m, sigma)


def clustered_points(seed):
    """tests/test_hashgrid.py's gradient points: half spread over the box,
    half in one small cluster, so that coarse levels collide heavily."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.9, 0.9, (64, 3)),
                           rng.uniform(0.01, 0.02, (64, 3))]).astype(np.float32)


def port_grads(tree, pts, dirs, cfg):
    field = hg.HashGridField(tree, requires_grad=True)
    rgb, sigma = hg.hashgrid_mlp(field, torch.from_numpy(pts), torch.from_numpy(dirs), cfg=cfg)
    (torch.sum(rgb ** 2) + torch.sum(torch.tanh(sigma))).backward()
    return {name: p.grad.numpy() for name, p in field.weights.items()}


def jax_grads(tree, pts, dirs, cfg):
    def loss(p):
        rgb, sigma = jax_hg.hashgrid_mlp(p, jnp.asarray(pts), jnp.asarray(dirs), cfg=cfg)
        return jnp.sum(rgb ** 2) + jnp.sum(jnp.tanh(sigma))

    g = jax.grad(loss)(jax_tree(tree))
    out = {"hash_tables": np.asarray(g["hash_tables"])}
    for layer in hg.LAYERS:
        for part in ("kernel", "bias"):
            out[f"{layer}_{part}"] = np.asarray(g[layer][part])
    return out


@pytest.mark.parametrize("grad_impl, rtol, atol", [("scatter", 1e-5, None),
                                                   ("sorted", 2e-4, 2e-6)])
def test_gradients_match_jax(grad_impl, rtol, atol):
    """d(tables) and every MLP gradient through the plain backward against
    jax.grad of the JAX field with the same grad_impl. "scatter": the sums
    differ in order only (rtol 1e-5; atol 1e-6 of the largest entry, for
    the entries that cancel to about zero). "sorted": differences of a
    running f32 sum, JAX's own bar (tests/test_hashgrid.py:282-284)."""
    tree = np_tree(TINY_KW, 9, table_scale=0.3)
    pts = clustered_points(10)
    dirs = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (128, 1))
    got = port_grads(tree, pts, dirs, TINY.replace(grad_impl=grad_impl))
    want = jax_grads(tree, pts, dirs, JAX_TINY.replace(grad_impl=grad_impl))
    assert float(np.abs(want["hash_tables"]).max()) > 0.0
    atol = 1e-6 * float(np.abs(want["hash_tables"]).max()) if atol is None else atol
    for name, w in want.items():
        tol = (rtol, atol) if name == "hash_tables" else (1e-5, 1e-7)
        np.testing.assert_allclose(got[name], w, rtol=tol[0], atol=tol[1], err_msg=name)


def test_points_gradient_matches_jax():
    """d(points) through the trilinear weights, with the clip's gradient
    as JAX gives it (1/2 on the box's faces, 0 outside)."""
    tables = np_tree(TINY_KW, 11)["hash_tables"]
    pts = encode_points(12)
    pts = pts[np.isfinite(pts).all(-1)]
    cot = np.random.default_rng(13).normal(size=(pts.shape[0], 8)).astype(np.float32)
    p = torch.from_numpy(pts).requires_grad_(True)
    torch.sum(fused_hash_encode(torch.from_numpy(tables), p, TINY) * torch.from_numpy(cot)).backward()
    want = jax.grad(lambda q: jnp.sum(jax_hg.hash_encode(jnp.asarray(tables), q, JAX_TINY)
                                      * cot))(jnp.asarray(pts))
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def render_case(seed, n_fine, return_aux):
    tree = np_tree(TINY_KW, seed, table_scale=0.5)
    rng = np.random.default_rng(seed + 1)
    dirs = unit(rng, 24)
    origin = np.asarray([0.3, -2.6, 0.4], np.float32)
    ids = np.arange(24) + 100
    kw = dict(n_coarse=8, n_fine=n_fine, model="hashgrid")
    want = jax_render_rays(jax_tree(tree), jax_tree(tree), jnp.asarray(origin), jnp.asarray(dirs),
                           1.0, 5.0, jax.random.key(seed), JaxRenderConfig(hash=JAX_TINY, **kw),
                           ray_ids=jnp.asarray(ids, jnp.int32), return_aux=return_aux)
    field = hg.HashGridField(tree)
    got = render_rays(field, field, torch.from_numpy(origin), torch.from_numpy(dirs), 1.0, 5.0,
                      random.key(seed, "cpu"), RenderConfig(hash=TINY, **kw),
                      ray_ids=torch.from_numpy(ids), return_aux=return_aux)
    return got, want


@pytest.mark.parametrize("n_fine, return_aux", [(16, False), (0, False), (16, True)],
                         ids=["two_pass", "single_pass", "aux"])
def test_render_rays_matches_jax(n_fine, return_aux):
    """One shared field for both passes, as the family trains: the port's
    render equals JAX's within 1e-5 (depth 1e-4: it sums t ~ 3 times the
    weights)."""
    got, want = render_case(14, n_fine, return_aux)
    if return_aux:
        (got, aux), (want, want_aux) = (got, want)
        assert sorted(aux) == sorted(want_aux)
        for name, value in want_aux.items():
            atol = 1e-4 if name == "depth" else 1e-5
            np.testing.assert_allclose(aux[name].numpy(), np.asarray(value), atol=atol, rtol=0,
                                       err_msg=name)
    assert float(np.abs(np.asarray(want) - 1.0).max()) > 0.05      # not just background
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def dense_core_tree():
    """A field with dense cores in empty space: strong coarse levels, weak
    fine ones (smooth, so that an ulp of sigma moves no fine sample far),
    and a density head scaled and biased so that about 10% of the box is
    above accel's threshold of 0.01 (half the cells once dilated)."""
    tree = np_tree(TINY_KW, 18, table_scale=3.0)
    tree["hash_tables"][2:] *= 0.05
    tree["sigma1"]["kernel"][:, 0] *= 6.0
    tree["sigma1"]["bias"][0] = -6.7
    return tree


def test_grid_of_the_field_matches_jax():
    """hashgrid_grid_kwargs: the density lattice of the field over its own
    box (to 1e-5 relative), and the scene grid's cells, equal to JAX's."""
    tree = dense_core_tree()
    rcfg, jcfg = RenderConfig(model="hashgrid", hash=TINY), JaxRenderConfig(model="hashgrid",
                                                                              hash=JAX_TINY)
    kw, jkw = accel.hashgrid_grid_kwargs(rcfg), jax_accel.hashgrid_grid_kwargs(jcfg)
    assert kw["aabb"] == (-1.0, 1.0)
    field = hg.HashGridField(tree)
    got = accel.density_grid(field, resolution=8, **kw).numpy()
    want = np.asarray(jax_accel.density_grid(jax_tree(tree), resolution=8, **jkw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    grid = accel.build_scene_grid(field, field, resolution=8, **kw)
    jgrid = jax_accel.build_scene_grid(jax_tree(tree), jax_tree(tree), resolution=8, **jkw)
    occ = grid.occ.numpy()
    assert 0.0 < occ.mean() < 1.0
    np.testing.assert_array_equal(occ, np.asarray(jgrid.occ))
    np.testing.assert_allclose(grid.aabb_max.numpy(), np.asarray(jgrid.aabb_max))


IMAGE_CASES = [("mask_plain", dict(accel_compact="none"), 1e-5),
               ("bench_probes_k3", dict(accel_compact="off", accel_aabb_probes=16,
                                        accel_cull_rays=True, sampling_impl="pallas"), 2e-3)]


@pytest.mark.parametrize("name, change, tol", IMAGE_CASES, ids=[c[0] for c in IMAGE_CASES])
def test_render_image_with_grid_matches_jax(name, change, tol):
    """render_image of the field through a grid of its own sigma
    (hashgrid_grid_kwargs) against JAX's, on one numpy grid: 1e-5 with the
    plain chain and mask-only culling; 2e-3 with K3's plain version and
    the bench's probe culling and ray packing (K3 against JAX's K3: scan
    orders differ), on the hit rays whose image-level ranges agree."""
    tree = dense_core_tree()
    jcfg = JaxRenderConfig(n_coarse=8, n_fine=16, ray_chunk=48, model="hashgrid", hash=JAX_TINY,
                           **change)
    cfg = RenderConfig(n_coarse=8, n_fine=16, ray_chunk=48, model="hashgrid", hash=TINY, **change)
    jgrid = jax_accel.build_scene_grid(jax_tree(tree), jax_tree(tree), resolution=16,
                                       **jax_accel.hashgrid_grid_kwargs(jcfg))
    occ = np.asarray(jgrid.occ)
    assert 0.0 < occ.mean() < 1.0
    grid = accel.grid_from_numpy(occ, -1.0, 1.0, "cpu")
    side = 12
    want = np.asarray(jax_render_image(jax_tree(tree), jax_tree(tree), JCAM, side, side,
                                       jax.random.key(5), jcfg, grid=jgrid))
    field = hg.HashGridField(tree)
    got = render_image(field, field, CAM, side, side, random.key(5, "cpu"), cfg, grid=grid).numpy()
    rows = np.ones((side, side), bool)
    if cfg.accel_aabb_probes:
        _, d = camera_rays(CAM, side, side, "cpu")
        (t0, t1), _, _ = _image_ray_ranges(grid, torch.from_numpy(CAM.position), d,
                                           torch.tensor(CAM.near), torch.tensor(CAM.far), cfg)
        _, jd = jax_camera_rays(side)
        (j0, j1), _, _ = jax_image_ray_ranges(jgrid, jnp.asarray(CAM.position), jd,
                                              jnp.asarray(CAM.near), jnp.asarray(CAM.far), jcfg)
        t0, t1 = t0.numpy().reshape(side, side), t1.numpy().reshape(side, side)
        j0, j1 = np.asarray(j0).reshape(side, side), np.asarray(j1).reshape(side, side)
        rows = (np.abs(t0 - j0) <= 1e-6) & (np.abs(t1 - j1) <= 1e-6)
        assert rows.mean() >= 0.95
        rows &= t1 > t0
    assert rows.mean() > 0.05
    assert float(np.abs(want[rows] - 1.0).max()) > 0.05
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=0)


def jax_camera_rays(side):
    from nerf_rs_tpu.ops.rays import camera_rays as jax_rays

    return jax_rays(JCAM, side, side)


def np_batch(n, seed):
    """Rays from a sphere of radius 3 toward the box, with targets."""
    rng = np.random.default_rng(seed)
    v = unit(rng, n)
    dirs = -v + 0.2 * rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"origins": (3.0 * v).astype(np.float32), "dirs": dirs.astype(np.float32),
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32),
            "near": np.float32(1.0), "far": np.float32(5.0)}


def train_cfgs():
    kw = dict(n_coarse=8, n_fine=16, ray_chunk=32, model="hashgrid")
    return (JaxTrainConfig(batch_rays=32, render=JaxRenderConfig(hash=JAX_TINY, **kw), **RECIPE),
            TrainConfig(batch_rays=32, render=RenderConfig(hash=TINY, **kw), **RECIPE))


def test_create_train_state_is_one_shared_field():
    _, cfg = train_cfgs()
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    assert set(state.params) == {"shared"}
    field = state.params["shared"]
    assert isinstance(field, hg.HashGridField)
    coarse, fine = split_params(state.params)
    assert coarse is fine is field
    tables = field.weights["hash_tables"]
    assert tables.shape == (4, 1 << 12, 2) and tables.requires_grad
    tables = tables.detach()
    assert float(tables.abs().max()) <= 1e-4 and float(tables.std()) > 1e-5
    assert set(state.mu["shared"]) == set(field.weights)
    assert not field.weights["sigma0_bias"].any()


def test_train_step_matches_jax():
    """One step of the CLI recipe from a JAX state carried across: the loss
    to 1e-5 relative, the parameters within tests/test_train.py's bound
    (two learning rates; under 0.1% of the entries more than 1e-5 apart)."""
    jcfg, cfg = train_cfgs()
    b = np_batch(32, 17)
    jstate = jax_train.create_train_state(jax.random.key(0), jcfg)
    adam = jstate.opt_state[0]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)          # noqa: E731
    state = train_state_from_numpy(to_np(jstate.params), to_np(adam.mu), to_np(adam.nu),
                                   int(adam.count), int(jstate.step), "cpu")
    assert isinstance(state.params["shared"], hg.HashGridField)
    jstate, want = jax_train.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                        jax.random.key(1), jcfg)
    state, got = train_step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                            random.key(1, "cpu"), cfg)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert state.step == 1 and state.count == 1
    jp = to_np(jstate.params["shared"])
    field = state.params["shared"]
    for name, p in field.weights.items():
        layer, _, part = name.rpartition("_")
        w = jp["hash_tables"] if name == "hash_tables" else jp[layer][part]
        diff = np.abs(p.detach().numpy() - w)
        assert diff.max() < 2 * cfg.lr_init, (name, diff.max())
        assert (diff > 1e-5).mean() < 1e-3, name


def test_training_reduces_loss():
    """Eight steps on one batch lower the loss (tests/test_hashgrid.py:171-189)."""
    _, cfg = train_cfgs()
    cfg = cfg.replace(lr_final=cfg.lr_init)
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    b = {k: torch.as_tensor(v) for k, v in np_batch(32, 18).items()}
    b["rgb"] = torch.full((32, 3), 0.3)
    losses = [float(train_step(state, b, random.fold_in(random.key(10, "cpu"), torch.tensor(i)),
                               cfg)[1]["loss"]) for i in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_cli_train_hashgrid_on_cpu(capsys):
    rc = cli_main(["train", "--device", "cpu", "--model", "hashgrid", "--hash-levels", "4",
                   "--hash-table-log2", "12", "--hash-res-max", "64", "--steps", "3",
                   "--batch-rays", "32", "--coarse-samples", "8", "--fine-samples", "8",
                   "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = re.findall(r"^step (\d+): loss ([0-9.]+) psnr ([0-9.]+) \(([0-9,]+) rays/s fwd\+bwd\)$",
                       out, flags=re.M)
    assert [int(s) for s, *_ in lines] == [0, 1, 2], out
    assert "distilling from the pretrained lego networks" in out


# --- The encode kernel's design (csrc/hash_encode.cu), emulated on the CPU.

TILE = 64                                  # kTile: samples a CTA
U32 = 0xFFFFFFFF


def ray_points(rays, samples, seed, half=1.0):
    """Points along rays, samples sorted along each ray as the render makes
    them: origins on a sphere of radius 2 half around the box (-half,
    half)^3, directions at its centre jittered, t stratified over [half,
    3 half]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(rays, 3))
    o = 2.0 * half * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.normal(size=(rays, 3)) * 0.18
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = half * (1.0 + 2.0 * (np.arange(samples) + rng.uniform(size=(rays, samples))) / samples)
    return (o[:, None, :] + d[:, None, :] * t[..., None]).astype(np.float32)


def emulate_kernel_encode(tables, points, cfg, tile=TILE):
    """The encode kernel's dataflow in torch ops -> (output, share of the
    corner pairs fetched by one load). Tiles of ``tile`` samples, each
    point normalized once (a tail tile's missing samples at 0); per level
    the cells, the corner rows in uint32 arithmetic and the weights; with
    F = 2 and T even, four corner pairs (the x pair on a hashed level, the z
    pair on a direct one), both from one load of their aligned pair of rows
    where they are its two rows, else each from its own row;
    the sum in corner order; each tile's rows staged as bytes at a padded
    pitch and copied out point-major in 16-byte chunks (4-byte words where
    a row is not whole chunks). Other F: one load a feature, straight to
    the output."""
    levels, table_size, features = tables.shape
    res, np1, direct = level_constants(cfg, table_size)
    pts = points.reshape(-1, 3).to(torch.float32)
    n = pts.shape[0]
    n_tiles = -(-n // tile)
    flat = tables.reshape(levels * table_size, features)
    es = tables.element_size()
    row_bytes = levels * features * es
    pitch = ((row_bytes + 15) & ~15) + 16
    pair = features == 2 and table_size % 2 == 0
    lo, hi = cfg.aabb
    xs = torch.zeros(n_tiles * tile, 3)
    x = (pts - lo) / (hi - lo)
    xs[:n] = torch.where(torch.isnan(x), torch.zeros_like(x), torch.clamp(x, 0.0, 1.0))
    staged = torch.zeros((n_tiles * tile, pitch), dtype=torch.uint8)
    direct_out = torch.zeros((n_tiles * tile, levels * features), dtype=tables.dtype)
    py, pz = hg._PRIMES[1], hg._PRIMES[2]
    one_load, pairs = 0, 0
    for l in range(levels):
        r = torch.tensor(res[l])
        pos = r * xs
        i0 = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), r - 1.0)
        cell, frac = i0.to(torch.int64), pos - i0
        cx, cy, cz = cell.unbind(-1)
        if direct[l]:
            n1 = int(np1[l])
            r0 = ((cx * n1 + cy) * n1 + cz) & U32
            idx = [(r0 + (c >> 2) * n1 * n1 + ((c >> 1) & 1) * n1 + (c & 1)) & U32
                   for c in range(8)]
        else:
            hy0, hz0 = (cy * py) & U32, (cz * pz) & U32
            hy = (hy0, (hy0 + py) & U32)
            hz = (hz0, (hz0 + pz) & U32)
            idx = [((cx + (c >> 2)) ^ hy[(c >> 1) & 1] ^ hz[c & 1]) & (table_size - 1)
                   for c in range(8)]
        fx, fy, fz = frac.unbind(-1)
        w = [((fx if c >> 2 else 1.0 - fx) * (fy if (c >> 1) & 1 else 1.0 - fy))
             * (fz if c & 1 else 1.0 - fz) for c in range(8)]
        level = flat[l * table_size:(l + 1) * table_size]
        if pair:
            v = [None] * 8
            for p in range(4):
                ca, cb = (2 * p, 2 * p + 1) if direct[l] else (p, p + 4)
                ia, ib = idx[ca], idx[cb]
                same = (ia ^ ib) == 1
                q = level.reshape(table_size // 2, 2, 2)[ia >> 1]      # the aligned pair
                v[ca] = torch.where(same[:, None],
                                    torch.where((ia & 1).bool()[:, None], q[:, 1], q[:, 0]),
                                    level[ia])
                v[cb] = torch.where(same[:, None],
                                    torch.where((ib & 1).bool()[:, None], q[:, 1], q[:, 0]),
                                    level[ib])
                one_load += int(same[:n].sum())
                pairs += n
            acc = v[0].to(torch.float32) * w[0][:, None]
            for c in range(1, 8):
                acc = acc + v[c].to(torch.float32) * w[c][:, None]
            staged[:, l * 2 * es:(l + 1) * 2 * es] = \
                acc.to(tables.dtype).contiguous().view(torch.uint8)
        else:
            for f in range(features):
                acc = None
                for c in range(8):
                    term = flat[idx[c] + l * table_size, f].to(torch.float32) * w[c]
                    acc = term if acc is None else acc + term
                direct_out[:, l * features + f] = acc.to(tables.dtype)
    if not pair:
        return direct_out[:n].reshape(*points.shape[:-1], levels * features), 0.0
    unit = 16 if row_bytes % 16 == 0 else 4
    per_row = row_bytes // unit
    dst = torch.zeros(n * row_bytes, dtype=torch.uint8)
    span = torch.arange(unit)
    for t in range(n_tiles):
        s0, rows = t * tile, min(tile, n - t * tile)
        i = torch.arange(rows * per_row)
        r = i // per_row
        src = staged[s0:s0 + tile].reshape(-1)
        dst[s0 * row_bytes + (i * unit)[:, None] + span] = \
            src[(r * pitch + (i - r * per_row) * unit)[:, None] + span]
    out = dst.view(tables.dtype).reshape(*points.shape[:-1], levels * features)
    return out, one_load / pairs


PAPER = HashGridConfig()
ENCODE_CASES = [
    # (name, config kwargs, dtype, points)
    ("tiny_f32_scattered_nan_inf", TINY_KW, torch.float32, lambda: encode_points(30)),
    ("tiny_bf16_scattered_nan_inf", TINY_KW, torch.bfloat16, lambda: encode_points(31)),
    ("tiny_f32_one_point", TINY_KW, torch.float32, lambda: encode_points(32)[5:6]),
    ("tiny_bf16_rays_tail_tile", TINY_KW, torch.bfloat16, lambda: ray_points(3, 50, 33)),
    ("paper_f32_rays", {}, torch.float32, lambda: ray_points(4, 64, 34, half=2.0)),
    ("paper_bf16_rays", {}, torch.bfloat16, lambda: ray_points(2, 192, 35, half=2.0)),
    ("wide_f8_f32", WIDE_KW, torch.float32, lambda: encode_points(36)),
    ("wide_f8_bf16", WIDE_KW, torch.bfloat16, lambda: ray_points(3, 50, 37)),
]


@pytest.mark.parametrize("name, kw, dtype, make_points", ENCODE_CASES,
                         ids=[c[0] for c in ENCODE_CASES])
def test_kernel_dataflow_emulation_equals_the_plain_version(name, kw, dtype, make_points):
    """The encode kernel's dataflow (level-major groups over a sample tile,
    paired loads, the corner-order sum, the staged point-major write),
    emulated in torch ops, is bitwise the plain version: at a tail tile,
    at one point, with NaN and inf points, F = 8 on the generic path."""
    cfg = HashGridConfig(**kw)
    tables = torch.from_numpy(np_tree(kw, 38)["hash_tables"]).to(dtype)
    pts = torch.from_numpy(make_points())
    got, shared = emulate_kernel_encode(tables, pts, cfg)
    want = hash_encode_reference(tables, pts, cfg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16 else got.view(torch.int32),
                       want.view(torch.int16) if dtype == torch.bfloat16 else
                       want.view(torch.int32))
    if cfg.features == 2 and pts.reshape(-1, 3).shape[0] > 1:
        assert 0.0 < shared < 1.0              # both kinds of pair are exercised


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(cells=st.lists(st.tuples(st.integers(0, 1023), st.integers(0, 1023),
                                st.integers(0, 1023)), min_size=1, max_size=16))
def test_paired_loads_rest_on_the_corner_rows(cells):
    """The rule the encode kernel's paired loads rest on, through the
    port's _Corners at the paper config (5 direct levels, 11 hashed): on a
    hashed level with even cx the x pair's rows are 2k and 2k + 1 (in
    either order: one aligned 16-byte chunk in f32); on a direct level the
    z pair's rows are idx and idx + 1, one aligned chunk where idx is
    even."""
    table_size = 1 << PAPER.table_log2
    _, _, direct = level_constants(PAPER, table_size)
    direct = torch.from_numpy(direct.astype(bool))
    assert bool(direct.any()) and not bool(direct.all())
    c = torch.tensor(cells, dtype=torch.int64)
    even = c.clone()
    even[:, 0] &= ~1
    c = torch.cat([c, even])              # each cell also with an even cx
    ns = torch.tensor(hg.level_resolutions(PAPER), dtype=torch.int64)
    comps = [(torch.minimum(c[:, a:a + 1], ns - 1), torch.zeros(len(c), PAPER.levels))
             for a in range(3)]
    rows = [_Corners(comps, PAPER, table_size, "cpu")(k)[0] for k in range(8)]
    hashed_even = ~direct & (comps[0][0] % 2 == 0)
    assert bool(hashed_even.any())
    for p in range(4):
        xa, xb = rows[p], rows[p + 4]
        assert bool((((xa ^ xb) == 1) | ~hashed_even).all())
        za, zb = rows[2 * p], rows[2 * p + 1]
        assert bool(((zb == za + 1) | ~direct).all())
        assert bool((((za ^ zb) == 1) | ~(direct & (za % 2 == 0))).all())


def test_sector_reckoning_tool_counts_the_corner_rows():
    """tools/torch_hash_sectors.py on a few rays: every corner row in the
    table, distinct sectors a sample falling as tiles grow, and the
    level-major warps' instruction sectors below the first kernel's."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / "torch_hash_sectors.py"
    spec = importlib.util.spec_from_file_location("torch_hash_sectors", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rows = tool.corner_rows(256)
    assert rows.shape == (256, tool.SAMPLES, PAPER.levels, 8)
    assert int(rows.min()) >= 0 and int(rows.max()) < PAPER.levels << PAPER.table_log2
    flat = (rows * 8 // 32).reshape(-1, PAPER.levels, 8)
    n = flat.shape[0]
    per_tile = [float(tool.distinct(flat.reshape(n // t, t, PAPER.levels, 8).transpose(1, 2)
                                    .reshape(n // t, PAPER.levels, t * 8)).sum()) / n
                for t in (1, 16, 64)]
    assert per_tile[0] > per_tile[1] > per_tile[2] > 0
    first = float(tool.distinct(flat.reshape(n // 2, 2 * PAPER.levels, 8).transpose(1, 2)).sum())
    major = float(tool.distinct(flat.reshape(n // 32, 32, PAPER.levels, 8)
                                .permute(0, 2, 3, 1)).sum())
    assert major < first
