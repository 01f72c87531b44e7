"""PyTorch port, occupancy-culled and placement-aware training: nerf_loss
and train_step with a grid against the JAX package on one numpy grid, the
grid refresh of ``train --accel-every`` against the JAX CLI's, and the
CLI's ``--accel-*`` flags against the JAX CLI.

The comparisons with JAX hand both packages one numpy grid, a shell of
occupied cells that tests/test_train.py's rays from the origin cross, so
that it culls, compacts and places their samples; the port's versions of
tests/test_train.py's grid tests use the lego teacher's grid as that file
builds it. On the CPU the port's impl="pallas" runs the fused kernels'
plain versions; the kernels on compacted rows are held to them on the card
(``tests/test_torch_cuda.py``)."""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nerf_rs_tpu.accel as jax_accel
from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.train import create_train_state as jax_create_train_state
from nerf_rs_tpu.train import nerf_loss as jax_nerf_loss
from nerf_rs_tpu.train import train_step as jax_train_step
from nerf_rs_tpu_torch import accel
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
from nerf_rs_tpu_torch.io.weights import load_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.train import (
    create_train_state,
    nerf_loss,
    refresh_grid,
    train_state_from_numpy,
    train_step,
)
from test_torch_cli import LEGO
from test_torch_train import (
    assert_params_close,
    np_batch,
    port_state_from_jax,
    to_np,
    torch_batch,
)

torch.set_num_threads(1)

SMALL = dict(width=128, v_width=64, depth=4, skip_at=2)
RAYS = 64
# A shell of occupied cells, 2.8 < |x| < 4.6 above z = -2, on a 16^3 grid
# over (-6.5, 6.5)^3: rays from the origin (tests/test_train.py's batch)
# cross it between t = 2.8 and 4.6 of their [2, 6], so that it culls,
# compacts and places their samples.
SHELL_RES, SHELL_BOX = 16, 6.5


def shell_occupancy():
    c = -SHELL_BOX + (np.arange(SHELL_RES) + 0.5) * (2 * SHELL_BOX / SHELL_RES)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    d = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    return (d > 2.8) & (d < 4.6) & (gz > -2.0)


@pytest.fixture(scope="module")
def shell_grid():
    """(JAX grid, port grid) of the shell, from one numpy array."""
    occ = shell_occupancy()
    jax_grid = jax_accel.OccupancyGrid(occ=jnp.asarray(occ),
                                       aabb_min=jnp.full((3,), -SHELL_BOX, jnp.float32),
                                       aabb_max=jnp.full((3,), SHELL_BOX, jnp.float32))
    return jax_grid, accel.grid_from_numpy(occ, -SHELL_BOX, SHELL_BOX, "cpu")


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def lego_np():
    return {net: load_nerf_params(LEGO / net) for net in ("coarse", "fine")}


@pytest.fixture(scope="module")
def lego_grid(lego_np):
    """The lego teacher's grid on the port: JAX's build_scene_grid at 24^3
    over (-1.8, 1.8), sigma > 0.1, dilated once, as tests/test_train.py
    builds it."""
    jax_params = jax.tree_util.tree_map(jnp.asarray, lego_np)
    g = jax_accel.build_scene_grid(jax_params["coarse"], jax_params["fine"], resolution=24,
                                   aabb=(-1.8, 1.8), sigma_threshold=0.1, chunk=24 ** 3,
                                   mlp_fn=lambda p, x, d: jax_nerf_mlp(p, x, d))
    return accel.grid_from_numpy(np.asarray(g.occ), -1.8, 1.8, "cpu")


def configs(n_coarse, n_fine, arch=None, **accel_kw):
    """(JAX, port) TrainConfigs: 64 rays, the given sample counts, arch
    (default: the canonical 8x256) and accel fields, impl="xla"."""
    arch = arch or {}
    jax_cfg = JaxTrainConfig(batch_rays=RAYS, arch=JaxArchConfig(**arch), render=JaxRenderConfig(
        n_coarse=n_coarse, n_fine=n_fine, ray_chunk=RAYS, **accel_kw))
    port_cfg = TrainConfig(batch_rays=RAYS, arch=ArchConfig(**arch), render=RenderConfig(
        n_coarse=n_coarse, n_fine=n_fine, ray_chunk=RAYS, **accel_kw))
    return jax_cfg, port_cfg


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads():
    return jax.jit(jax.value_and_grad(jax_nerf_loss, has_aux=True), static_argnames=("cfg",))


COMPACT = dict(accel_coarse_capacity=0.75, accel_fine_capacity=0.75)
CULL_CASES = {
    # (n_coarse, n_fine, accel fields, port impl)
    "mask-only 8+8": (8, 8, dict(accel_compact="none"), "xla"),
    "scatter 8+8": (8, 8, dict(accel_compact="scatter", **COMPACT), "xla"),
    "gather 8+8": (8, 8, dict(accel_compact="gather", **COMPACT), "xla"),
    "mask-only 64+128": (64, 128, dict(accel_compact="none"), "xla"),
    "scatter 64+128": (64, 128, dict(accel_compact="scatter", **COMPACT), "xla"),
    "gather 64+128": (64, 128, dict(accel_compact="gather", **COMPACT), "xla"),
    "scatter 64+128, fused MLP": (64, 128, dict(accel_compact="scatter", **COMPACT), "pallas"),
    "placement, box, single pass": (64, 0, dict(accel_sample_aabb=True), "xla"),
    "placement, 16 probes, single pass": (64, 0, dict(accel_sample_aabb=True,
                                                      accel_aabb_probes=16), "xla"),
    "placement, 16 probes, gather, single pass": (64, 0, dict(
        accel_sample_aabb=True, accel_aabb_probes=16, accel_compact="gather", **COMPACT), "xla"),
    "placement, 16 probes, scatter 8+8": (8, 8, dict(
        accel_sample_aabb=True, accel_aabb_probes=16, accel_pad_probes=4.0,
        accel_compact="scatter", **COMPACT), "xla"),
}


def capacity_rows(rcfg, n_rays):
    """The rows of each pass's capacity, as render.render_rays sizes them."""
    rows_c, rows_f = n_rays * rcfg.n_coarse, n_rays * (rcfg.n_coarse + rcfg.n_fine)
    if rcfg.accel_compact == "none":
        return rows_c, rows_f
    return (-(-max(1, int(rows_c * rcfg.accel_coarse_capacity)) // 1024) * 1024,
            -(-max(1, int(rows_f * rcfg.accel_fine_capacity)) // 1024) * 1024)


def assert_live_fracs_equal(got, want, rcfg, n_rays):
    """``accel_overflow`` equal, and each pass's live rows (its
    ``live_frac`` times its capacity) equal: the port divides the count by
    the capacity exactly rounded, JAX's XLA multiplies by the capacity's
    rounded reciprocal, one f32 ulp apart off powers of two."""
    assert float(got["accel_overflow"]) == float(want["accel_overflow"])
    for name, rows in zip(("live_frac_coarse", "live_frac_fine"), capacity_rows(rcfg, n_rays)):
        g, w = float(got[name]), float(want[name])
        assert round(g * rows) == round(w * rows), name
        np.testing.assert_allclose(g, w, rtol=2 ** -23, atol=0, err_msg=name)


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_culled_nerf_loss_and_grads_match_jax(shell_grid, case):
    """nerf_loss with the shell grid in every culling mode and with
    placement, against JAX's on tests/test_train.py's state, batch and key:
    the loss to 1e-5 relative; ``live_frac_*`` and ``accel_overflow``
    equal; the gradients to tests/test_torch_train.py's bars for the dense
    loss: every leaf within atol 1e-6, rtol 1e-4, but the fine network's
    under importance sampling within 2e-2 of its norm a leaf (an ulp of a
    coarse sigma moves the fine samples, which the encode's 2^9 frequency
    amplifies: on these inputs the dense 64+128 loss's fine gradients are
    up to 8e-3 of their norm from JAX's, and 51x over the atol/rtol bar).
    The gradients reach the parameters through the mask (``torch.where``),
    the scatter into the compaction buffer and the gather from it, and past
    the detached placement ranges."""
    n_coarse, n_fine, kw, impl = CULL_CASES[case]
    jax_cfg, port_cfg = configs(n_coarse, n_fine, **kw)
    port_cfg = port_cfg.replace(render=port_cfg.render.replace(impl=impl))
    jax_grid, port_grid = shell_grid
    b = np_batch(RAYS)
    jax_state = jax_create_train_state(jax.random.key(0), jax_cfg)
    (want_loss, want_m), want_g = jax_loss_and_grads()(jax_state.params, jax_batch(b),
                                                       jax.random.key(1), jax_cfg, jax_grid)
    state = port_state_from_jax(jax_state)
    loss, metrics = nerf_loss(state.params, torch_batch(b), random.key(1, "cpu"), port_cfg,
                              grid=port_grid)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name in ("mse_fine", "mse_coarse", "psnr"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-5)
    assert_live_fracs_equal(metrics, want_m, port_cfg.render, RAYS)
    assert 0.0 < float(metrics["live_frac_coarse"]) < 1.0            # the grid culled samples
    assert float(metrics["accel_overflow"]) == 0.0
    for net, tree in to_np(want_g).items():
        if n_fine == 0 and net == "fine":
            continue                                # single pass: the fine network is unused
        norm = 0.0
        for layer, parts in tree.items():
            for part, want in parts.items():
                got = state.params[net].weights[f"{layer}_{part}"].grad.numpy()
                norm += float(np.linalg.norm(got))
                if net == "fine":
                    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), (layer, part)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4,
                                               err_msg=f"{net}/{layer}/{part}")
        assert norm > 0.0, net


def test_culled_train_step_matches_jax(shell_grid):
    """One Adam step with the shell grid (gather compaction, box
    placement, 8 + 8 samples, the small arch) from the same state as JAX's:
    the loss to 1e-5, the parameters within tests/test_train.py's one-step
    bound; the port on the fused MLP's path, JAX on its plain one, as
    tests/test_torch_train.py::test_train_step_matches_jax holds them."""
    jax_cfg, port_cfg = configs(8, 8, SMALL, accel_compact="gather", accel_sample_aabb=True,
                                **COMPACT)
    port_cfg = port_cfg.replace(render=port_cfg.render.replace(impl="pallas"))
    jax_grid, port_grid = shell_grid
    b = np_batch(RAYS, seed=1)
    jax_state = jax_create_train_state(jax.random.key(0), jax_cfg)
    state = port_state_from_jax(jax_state)
    jax_state, want_m = jax_train_step(jax_state, jax_batch(b), jax.random.key(1), jax_cfg,
                                       grid=jax_grid)
    state, metrics = train_step(state, torch_batch(b), random.key(1, "cpu"), port_cfg,
                                grid=port_grid)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]), rtol=1e-5)
    assert_live_fracs_equal(metrics, want_m, port_cfg.render, RAYS)
    assert 0.0 < float(metrics["live_frac_coarse"]) < 1.0
    assert state.step == 1
    assert_params_close(to_np(jax_state.params), state, port_cfg.lr_init)


# ---- the port's versions of tests/test_train.py's grid tests ----

TINY = TrainConfig(batch_rays=64, render=RenderConfig(n_coarse=8, n_fine=8, ray_chunk=64))


def full_grid():
    return accel.grid_from_numpy(np.ones((8, 8, 8), bool), -6.5, 6.5, "cpu")


def tiny_state(cfg=TINY):
    return create_train_state(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("compact", ["none", "scatter", "gather"])
def test_train_step_with_full_grid_matches_dense(compact):
    """An all-occupied grid at capacity 1.0 with termination culling off
    is compaction as the identity: the culled step reproduces the dense
    step, the loss to 1e-6 relative and the parameters within two
    learning rates, under 0.1% of entries more than 1e-5 apart."""
    cfg = TINY.replace(render=TINY.render.replace(accel_coarse_capacity=1.0,
                                                  accel_fine_capacity=1.0,
                                                  accel_t_threshold=0.0, accel_compact=compact))
    batch = torch_batch(np_batch(cfg.batch_rays))
    s_dense, m_dense = train_step(tiny_state(cfg), batch, random.key(1, "cpu"), cfg)
    s_accel, m_accel = train_step(tiny_state(cfg), batch, random.key(1, "cpu"), cfg,
                                  grid=full_grid())
    np.testing.assert_allclose(float(m_accel["loss"]), float(m_dense["loss"]), rtol=1e-6)
    for net, module in s_accel.params.items():
        for name, p in module.weights.items():
            diff = (p - s_dense.params[net].weights[name]).abs().detach().numpy()
            assert diff.max() < 2 * cfg.lr_init, (net, name, diff.max())
            assert (diff > 1e-5).mean() < 1e-3, (net, name)


def test_accel_overflow_indicator():
    """accel_overflow is 1.0 exactly when a pass overflowed its capacity
    (capacities round up to 1024 rows: 256 rays x 8 coarse samples = 2048
    live rows against 1024), and mask-only culling cannot overflow."""
    state = tiny_state()
    roomy = TINY.replace(render=TINY.render.replace(accel_coarse_capacity=1.0,
                                                    accel_fine_capacity=1.0))
    _, m = nerf_loss(state.params, torch_batch(np_batch(64)), random.key(1, "cpu"), roomy, grid=full_grid())
    assert float(m["accel_overflow"]) == 0.0 and float(m["live_frac_coarse"]) <= 1.0
    for compact in ("scatter", "gather"):
        tight = TINY.replace(render=TINY.render.replace(
            accel_coarse_capacity=0.01, accel_fine_capacity=0.01, accel_compact=compact))
        _, m = nerf_loss(state.params, torch_batch(np_batch(256)), random.key(1, "cpu"), tight,
                         grid=full_grid())
        assert float(m["accel_overflow"]) == 1.0 and float(m["live_frac_coarse"]) > 1.0
    tight_mask = TINY.replace(render=TINY.render.replace(accel_coarse_capacity=0.01,
                                                         accel_fine_capacity=0.01))
    _, m = nerf_loss(state.params, torch_batch(np_batch(256)), random.key(1, "cpu"), tight_mask,
                     grid=full_grid())
    assert float(m["accel_overflow"]) == 0.0 and float(m["live_frac_coarse"]) <= 1.0


def test_train_step_with_teacher_grid_learns(lego_grid):
    """Culled training against the lego teacher's grid: the loss stays
    finite and falls over 10 steps on one batch."""
    state, cfg = tiny_state(), TINY
    batch = torch_batch(np_batch(cfg.batch_rays))
    losses = [float(train_step(state, batch, random.key(42, "cpu"), cfg,
                               grid=lego_grid)[1]["loss"]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_placement_aware_training_grads_flow(lego_grid):
    """Single-pass training under the serving presets' placement (box and
    16 probes): the loss is finite, every gradient finite and some
    non-zero, and the placement changes the loss against uniform
    [near, far] sampling."""
    cfg = TINY.replace(render=TINY.render.replace(n_fine=0, accel_sample_aabb=True,
                                                  accel_aabb_probes=16, accel_compact="none"))
    state = tiny_state(cfg)
    batch = torch_batch(np_batch(cfg.batch_rays))
    loss, _ = nerf_loss(state.params, batch, random.key(1, "cpu"), cfg, grid=lego_grid)
    loss.backward()
    norms = [float(p.grad.norm()) for m in state.params.values() for p in m.weights.values()
             if p.grad is not None]
    assert np.isfinite(float(loss)) and all(np.isfinite(norms)) and sum(norms) > 0.0
    loss_u, _ = nerf_loss(state.params, batch, random.key(1, "cpu"), cfg)
    assert float(loss) != float(loss_u)


# ---- the grid refresh of train --accel-every ----

SIGMA_THRESHOLD = 0.01      # build_occupancy_grid's default
# Cells whose sigma lies this close to the threshold may fall on either
# side between two float32 evaluations of the network.
NEAR_THRESHOLD = 1e-4


def jax_refresh(params, cfg, step, resolution, explore):
    """The JAX CLI's refresh_grid (nerf_rs_tpu/cli.py:652-709) on
    ``params``: (raw occupancy, final occupancy or None, the printed line,
    the step config's capacities)."""
    from nerf_rs_tpu.accel import build_scene_grid, capacities_from_occupancy
    from nerf_rs_tpu.render import get_mlp_fn

    mlp = get_mlp_fn(cfg.render)
    g = build_scene_grid(params["coarse"], params["fine"], resolution=resolution,
                         mlp_fn=lambda p, x, d: mlp(p, x, d, sigma_only=True))
    raw = occ = np.asarray(g.occ)
    raw_frac = float(occ.mean())
    if raw_frac < 0.005:
        return raw, None, (f"accel: grid only {raw_frac:.2%} occupied — training dense until "
                           "density forms"), None
    if explore > 0:
        occ = occ | (np.random.default_rng(cfg.seed + step).random(occ.shape) < explore)
    frac = float(occ.mean())
    cap_c, cap_f = capacities_from_occupancy(frac, cfg.render)
    if cap_c >= 1.0:
        return raw, None, (f"accel: grid {frac:.1%} occupied — culling would skip nothing, "
                           "training dense this period"), None
    if cfg.render.accel_compact in ("none", "off"):
        return raw, occ, f"accel: rebuilt {resolution}^3 grid ({frac:.1%} occupied; mask-only)", None
    return raw, occ, (f"accel: rebuilt {resolution}^3 grid ({frac:.1%} occupied; capacities "
                      f"{cap_c:.2f}/{cap_f:.2f})"), (cap_c, cap_f)


def near_threshold_cells(params, resolution):
    """Cells whose 3^3 neighbourhood holds a sigma of either network within
    NEAR_THRESHOLD of the threshold: the dilated grid may differ there."""
    near = np.zeros((resolution,) * 3, bool)
    for net in ("coarse", "fine"):
        sig = np.asarray(jax_accel.density_grid(jax.tree_util.tree_map(jnp.asarray, params[net]),
                                                resolution=resolution,
                                                mlp_fn=lambda p, x, d: jax_nerf_mlp(p, x, d)))
        near |= np.abs(sig - SIGMA_THRESHOLD) < NEAR_THRESHOLD
    return F.max_pool3d(torch.as_tensor(near, dtype=torch.float32)[None, None], 3, stride=1,
                        padding=1)[0, 0].numpy() > 0


@pytest.mark.parametrize("compact, explore", [("none", 0.0), ("none", 0.05),
                                              ("scatter", 0.05), ("gather", 0.0)])
def test_refresh_grid_matches_jax(lego_np, compact, explore):
    """The refresh from the lego fine network as the student's two networks
    at R = 16 (about 12% of the cells occupied after dilation): the raw
    occupancy equal to JAX's outside cells next to a sigma within 1e-4 of
    the 0.01 threshold (none here), the explored cells bitwise JAX's (the
    same numpy draws from seed + step), the same printed line and
    capacities."""
    jax_cfg, port_cfg = configs(64, 128, accel_compact=compact)
    jax_cfg = jax_cfg.replace(seed=3)
    port_cfg = port_cfg.replace(seed=3)
    student = {"coarse": lego_np["fine"], "fine": lego_np["fine"]}
    jax_params = jax.tree_util.tree_map(jnp.asarray, student)
    raw_want, occ_want, line_want, caps = jax_refresh(jax_params, jax_cfg, 7, 16, explore)
    modules = {net: NerfMLP(p) for net, p in student.items()}
    sweep = accel.field_grid_kwargs(port_cfg.render)
    raw, _, _ = refresh_grid(modules, port_cfg, 7, resolution=16, explore=0.0, sweep_kw=sweep)
    grid, step_cfg, line = refresh_grid(modules, port_cfg, 7, resolution=16, explore=explore,
                                        sweep_kw=sweep)
    near = near_threshold_cells(student, 16)
    assert not near.any()
    assert np.array_equal(raw.occ.numpy()[~near], raw_want[~near])
    assert line == line_want, (line, line_want)
    occ = grid.occ.numpy()
    drawn = np.random.default_rng(port_cfg.seed + 7).random(occ.shape) < explore
    assert np.array_equal(occ, raw.occ.numpy() | drawn)
    assert np.array_equal(occ, occ_want)
    if caps is None:
        assert step_cfg is port_cfg
    else:
        assert (step_cfg.render.accel_coarse_capacity,
                step_cfg.render.accel_fine_capacity) == caps


def test_refresh_grid_dense_fallbacks_match_jax(lego_np):
    """Both fallbacks to dense, with JAX's lines: an empty density (the
    sigma head's kernel zeroed, its bias below 0) is under 0.5% occupied; the lego networks
    (55% occupied) reach a coarse capacity of 1.0."""
    jax_cfg, port_cfg = configs(64, 128)
    empty = {net: {layer: ({"kernel": 0.0 * parts["kernel"], "bias": parts["bias"] - 1.0}
                           if layer == "alpha" else parts) for layer, parts in p.items()}
             for net, p in lego_np.items()}
    for params, explore in ((empty, 0.0), (lego_np, 0.0)):
        _, occ_want, line_want, _ = jax_refresh(jax.tree_util.tree_map(jnp.asarray, params),
                                                jax_cfg, 1, 16, explore)
        grid, step_cfg, line = refresh_grid({net: NerfMLP(p) for net, p in params.items()},
                                            port_cfg, 1, resolution=16, explore=explore,
                                            sweep_kw=accel.field_grid_kwargs(port_cfg.render))
        assert occ_want is None and grid is None and step_cfg is port_cfg
        assert line == line_want, (line, line_want)
    assert "grid only 0.00% occupied — training dense until density forms" in jax_refresh(
        jax.tree_util.tree_map(jnp.asarray, empty), jax_cfg, 1, 16, 0.0)[2]


# ---- the CLI ----

# tests/test_cli.py::test_cli_train_accel_refresh's arguments.
ACCEL_ARGS = ["train", "--steps", "3", "--batch-rays", "64", "--coarse-samples", "4",
              "--fine-samples", "8", "--ray-chunk", "64", "--impl", "xla", "--log-every", "1",
              "--accel-every", "1", "--accel-res", "8", "--accel-warmup", "1",
              "--accel-explore", "0.6"]


def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def accel_lines(out):
    return re.findall(r"^accel: .*$", out, flags=re.M)


@pytest.fixture(scope="module")
def jax_accel_run(tmp_path_factory):
    """The JAX CLI with ACCEL_ARGS, checkpointing every step."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    ck = tmp_path_factory.mktemp("jax_accel") / "ck"
    with pytest.MonkeyPatch.context() as m:
        m.setenv("NERF_NO_COMPILE_CACHE", "1")
        rc, out = run(jax_cli_main, [*ACCEL_ARGS, "--checkpoint-dir", str(ck),
                                     "--checkpoint-every", "1"])
    assert rc == 0
    return ck, out


def test_cli_train_accel_refresh_matches_jax(jax_accel_run):
    """The port's CLI with the JAX test's arguments (--ray-chunk 64 among
    them) trains 3 steps and prints JAX's accel: lines, a refresh at steps
    1 and 2 after the 1-step warm-up; the step lines carry no
    accel-load (those periods train dense)."""
    _, want = jax_accel_run
    rc, out = run(cli_main, [*ACCEL_ARGS, "--device", "cpu"])
    assert rc == 0
    assert len(accel_lines(want)) == 2
    assert accel_lines(out) == accel_lines(want)
    assert [int(s) for s in re.findall(r"^step (\d+): loss", out, flags=re.M)] == [0, 1, 2]
    assert "accel-load" not in out


def test_cli_resumed_run_rebuilds_its_grid_at_its_first_step(jax_accel_run, tmp_path):
    """The port resumed from JAX's own step-1 state with --accel-every 2:
    step 1 is no refresh boundary, but a resumed run rebuilds its grid at
    its first step, and prints JAX's line for that step (the same params,
    the same explore draws from seed + 1)."""
    from nerf_rs_tpu.config import TrainConfig as JaxTrain
    from nerf_rs_tpu.io.checkpoint import restore_checkpoint as jax_restore_checkpoint
    from nerf_rs_tpu_torch.io.checkpoint import save_checkpoint

    ck, want = jax_accel_run
    template = jax_create_train_state(jax.random.key(0), JaxTrain())
    jax_state = jax_restore_checkpoint(ck / "step_00000001", template)
    adam = jax_state.opt_state[0]
    save_checkpoint(tmp_path / "ck", train_state_from_numpy(
        to_np(jax_state.params), to_np(adam.mu), to_np(adam.nu), int(adam.count),
        int(jax_state.step), "cpu"))
    argv = [*ACCEL_ARGS, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")]
    argv[argv.index("--steps") + 1] = "2"
    argv[argv.index("--accel-every") + 1] = "2"
    rc, out = run(cli_main, argv)
    assert rc == 0
    assert f"resumed from {tmp_path / 'ck' / 'step_00000001'} at step 1" in out
    assert accel_lines(out) == accel_lines(want)[:1]


def test_cli_placement_needs_accel_every_as_in_jax():
    """--accel-aabb or --accel-probes without --accel-every exits with the
    JAX CLI's message."""
    from nerf_rs_tpu.cli import main as jax_cli_main

    for flags in (["--accel-aabb"], ["--accel-probes", "16"]):
        messages = []
        for main, extra in ((jax_cli_main, []), (cli_main, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                main(["train", *extra, *flags, "--steps", "1"])
            messages.append(str(e.value.code))
        assert messages[0] == messages[1]
        assert "need --accel-every" in messages[1]


def test_cli_accel_every_0_trains_dense(capsys):
    """JAX's default --accel-every 0 is accepted and trains without a grid."""
    assert cli_main(["train", "--device", "cpu", "--accel-every", "0", "--width", "64",
                     "--v-width", "32", "--depth", "3", "--skip-at", "1", "--steps", "2",
                     "--batch-rays", "32", "--coarse-samples", "4", "--fine-samples", "4",
                     "--log-every", "1", "--ray-chunk", "32", "--sampling-impl",
                     "pallas"]) == 0
    out = capsys.readouterr().out
    assert "accel" not in out
    assert [int(s) for s in re.findall(r"^step (\d+): loss", out, flags=re.M)] == [0, 1]


@pytest.mark.parametrize("family", ["mlp", "hashgrid", "int8qat"])
def test_cli_culled_placement_training_serves_every_family(family, capsys):
    """train --accel-every with --accel-aabb --accel-probes for the MLP,
    hash-grid and int8qat students: the grid is rebuilt from the student
    (a mask-only line), and the culled steps log accel-load."""
    flags = {"mlp": ["--width", "64", "--v-width", "32", "--depth", "3", "--skip-at", "1"],
             "hashgrid": ["--model", "hashgrid", "--hash-levels", "4", "--hash-table-log2",
                          "12", "--hash-res-max", "64"],
             "int8qat": ["--impl", "int8qat", "--width", "64", "--v-width", "32", "--depth",
                         "3", "--skip-at", "1"]}[family]
    assert cli_main(["train", "--device", "cpu", *flags, "--steps", "3", "--batch-rays", "32",
                     "--coarse-samples", "8", "--fine-samples", "0", "--teacher-samples",
                     "8,8", "--log-every", "1", "--accel-every", "2", "--accel-res", "16",
                     "--accel-warmup", "0", "--accel-explore", "0", "--accel-aabb",
                     "--accel-probes", "16", "--accel-pad", "4"]) == 0
    out = capsys.readouterr().out
    lines = accel_lines(out)
    assert len(lines) == 2, out
    steps = re.findall(r"^step (\d+): loss ([0-9.]+) .*$", out, flags=re.M)
    assert [int(s) for s, _ in steps] == [0, 1, 2] and all(np.isfinite(float(v)) for _, v in steps)
    if all("mask-only" in line for line in lines):
        assert len(re.findall(r"accel-load [0-9.]+/0\.00$", out, flags=re.M)) == 3
