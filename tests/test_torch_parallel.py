"""PyTorch port, multi-device rendering (``nerf_rs_tpu_torch/parallel/``)
against the port's single-device render and the JAX package's sharded
render on a mesh of two devices.

A world of 2 is two real processes under gloo on the CPU
(``tests/torch_parallel_worker.py``, launched with torchrun's variables),
as ``tests/test_multihost.py`` runs JAX's; a world of 1 is made inside
pytest (gloo, a ``file://`` store) and torn down by its fixture. The
frames are bitwise the port's single-device frames (every ray keyed by its
global index, and the plain path chunk-invariant on the CPU), and within
the tolerance the port's single-device frame keeps from JAX's."""

import contextlib
import datetime
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_rs_tpu import accel as jax_accel
from nerf_rs_tpu.config import HashGridConfig as JaxHashGridConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.ops.rays import camera_rays as jax_camera_rays
from nerf_rs_tpu.parallel import multihost as jax_multihost
from nerf_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nerf_rs_tpu.parallel.render_sharded import effective_chunk as jax_effective_chunk
from nerf_rs_tpu.parallel.render_sharded import render_image_aux_sharded as jax_aux_sharded
from nerf_rs_tpu.parallel.render_sharded import render_image_sharded as jax_image_sharded
from nerf_rs_tpu.render import _image_ray_ranges as jax_image_ray_ranges
from nerf_rs_tpu_torch import accel
from nerf_rs_tpu_torch.config import ArchConfig, HashGridConfig, RenderConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.models import hashgrid as hg
from nerf_rs_tpu_torch.models.mlp import arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import camera_rays
from nerf_rs_tpu_torch.parallel import Mesh, make_mesh, multihost
from nerf_rs_tpu_torch.parallel.render_sharded import (
    effective_chunk,
    render_image_aux_sharded,
    render_image_sharded,
)
from nerf_rs_tpu_torch.render import _image_ray_ranges, render_image, render_image_aux
from torch_parallel_worker import run_world

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LEGO = REPO / "assets" / "lego_rust"
GOLDEN = load_golden(LEGO / "tf_reference_samples.json")
CAM, JCAM = camera_from_golden(GOLDEN), jax_camera_from_golden(GOLDEN)
SMALL = ArchConfig(width=128, v_width=64, depth=4, skip_at=2)
HASH = dict(levels=4, table_log2=12, res_min=4, res_max=32, width=16, geo_features=7)


def np_params(arch, seed):
    """tests/test_torch_accel.py's SMALL nets: Glorot kernels and a dense
    field (alpha bias + 4). The fine samples move with the last bits of
    the coarse sigmas, and a sparser field turns that into more than 1e-5
    of colour between the two packages' f32 frames on some rays (bias + 2:
    1.06e-5 on 1 of these 768 values, in the single-device frames too)."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    out["alpha"]["bias"] += np.float32(4.0)
    return out


def np_hash_tree(seed):
    cfg = HashGridConfig(**HASH)
    rng = np.random.default_rng(seed)
    tree = {"hash_tables": rng.uniform(-1.0, 1.0, (cfg.levels, 1 << cfg.table_log2,
                                                   cfg.features)).astype(np.float32)}
    for name, (d_in, d_out) in hg.layer_shapes(cfg).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        tree[name] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return tree


def ball_occupancy(res=16, radius=0.8):
    """A ball of occupied cells over the box (-2, 2)^3 (tests/test_torch_accel.py's
    "ball", wider): at 16x16 it culls 186 of 256 rays by probes, 51 by the
    box chord."""
    c = -2.0 + (np.arange(res) + 0.5) * (4.0 / res)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    return gx ** 2 + gy ** 2 + gz ** 2 < radius ** 2


def render_cases():
    """The frames a world of 2 renders: name -> case (the worker's
    fields) and the JAX render's arguments."""
    small = (np_params(SMALL, 30), np_params(SMALL, 31))
    tree = np_hash_tree(40)
    occ = ball_occupancy()
    base = dict(n_coarse=8, n_fine=16, ray_chunk=128)
    # 32-ray chunks: each rank pads its share of the hit rays to whole
    # chunks, so the sharded frame renders more culled rays than the
    # single-device packed frame.
    culled = dict(n_coarse=8, n_fine=16, ray_chunk=32, accel_cull_rays=True)
    specs = {
        "plain": ("image", small, 2, base, None),
        "aux": ("aux", small, 3, base, None),
        "culled_aabb": ("image", small, 13, dict(culled, accel_sample_aabb=True), occ),
        # ray_chunk 200: each rank renders 128-ray chunks, the single
        # device 200-ray ones.
        "nondividing_chunk": ("image", small, 5, dict(base, ray_chunk=200), None),
        "hashgrid": ("image", (tree, tree), 6, dict(base, model="hashgrid", hash=HASH), None),
        "int8": ("image", small, 7, dict(base, impl="int8"), None),
        # bench.py's accel path (probe culling, box placement, packing, K3),
        # and probe culling without placement.
        "culled_bench": ("image", small, 14,
                         dict(culled, accel_compact="off", accel_sample_aabb=True,
                              accel_aabb_probes=16, sampling_impl="pallas"), occ),
        "culled_off_probes": ("image", small, 15,
                              dict(culled, accel_compact="off", accel_aabb_probes=16), occ),
        "multihost": ("multihost", small, 2, base, None),
    }
    cases = {}
    for name, (kind, (pc, pf), seed, cfg, grid) in specs.items():
        port_cfg = dict(cfg)
        if "hash" in port_cfg:
            port_cfg["hash"] = HashGridConfig(**HASH)
        cases[name] = dict(name=name, kind=kind, coarse=pc, fine=pf, camera=CAM, h=16, w=16,
                           seed=seed, cfg=RenderConfig(**port_cfg),
                           grid=None if grid is None else accel.grid_from_numpy(grid, -2.0, 2.0,
                                                                                "cpu"),
                           jax_cfg=dict(cfg, hash=JaxHashGridConfig(**HASH)) if "hash" in cfg
                           else cfg, occ=grid)
    return cases


CASES = render_cases()
FRAMES = ["plain", "aux", "culled_aabb", "nondividing_chunk", "hashgrid", "int8", "culled_bench"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every render case in one world of 2, joined from torchrun's
    variables."""
    return run_world(tmp_path_factory.mktemp("world2"),
                     [{k: v for k, v in c.items() if k not in ("jax_cfg", "occ")}
                      for c in CASES.values()], env_init=True)


def single_device(name):
    c = CASES[name]
    fn = render_image_aux if c["kind"] == "aux" else render_image
    return fn(c["coarse"], c["fine"], c["camera"], c["h"], c["w"], random.key(c["seed"], "cpu"),
              c["cfg"], device="cpu", grid=c["grid"])


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def jax_two_device(name):
    """JAX's sharded frame of the case on a mesh of two of the conftest's
    virtual CPU devices (its Pallas kernels in interpret mode)."""
    c = CASES[name]
    trees = tuple(jax.tree_util.tree_map(jnp.asarray, p) for p in (c["coarse"], c["fine"]))
    if c["coarse"] is c["fine"]:
        trees = (trees[0], trees[0])
    grid = None
    if c["occ"] is not None:
        grid = jax_accel.OccupancyGrid(occ=jnp.asarray(c["occ"]),
                                       aabb_min=jnp.full((3,), -2.0, jnp.float32),
                                       aabb_max=jnp.full((3,), 2.0, jnp.float32))
    fn = jax_aux_sharded if c["kind"] == "aux" else jax_image_sharded
    out = fn(*trees, JCAM, c["h"], c["w"], jax.random.key(c["seed"]),
             JaxRenderConfig(**c["jax_cfg"]), mesh=jax_make_mesh(jax.devices()[:2]), grid=grid)
    return tuple(np.asarray(x) for x in as_tuple(out))


@pytest.mark.parametrize("name", FRAMES)
def test_sharded_frame_is_bitwise_the_single_device_frame(world2, name):
    """Each rank's frame (every rank holds the whole frame after the one
    all-gather) equals render_image's (render_image_aux's) bit for bit."""
    want = as_tuple(single_device(name))
    for rank in world2:
        res = rank[name]
        assert res["error"] is None, res["error"]
        got = as_tuple(res["out"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), name
    assert float((want[0] - 1.0).abs().max()) > 0.05            # not just background


@pytest.mark.parametrize("name", FRAMES)
def test_sharded_frame_matches_jax_two_device_mesh(world2, name):
    """Against JAX's render_image_sharded over two devices, within the
    bars the port's single-device frames keep from JAX's: 1e-5 (depth 1e-4:
    it sums t ~ 4 times the weights; tests/test_torch_render.py), int8 at
    >= 60 dB (a code the last bit moves shifts a pixel by up to 0.03;
    tests/test_torch_quant.py), and with a grid on the rays whose
    image-level ranges agree to 1e-6 (at least 95%) and that hit, K3's
    plain version against JAX's K3 at 2e-3 (tests/test_torch_accel.py)."""
    got = [x.numpy() for x in as_tuple(world2[0][name]["out"])]
    want = jax_two_device(name)
    c = CASES[name]
    if name == "int8":
        mse = np.mean((got[0].astype(np.float64) - want[0]) ** 2)
        assert -10.0 * np.log10(max(mse, 1e-20)) >= 60.0
        return
    rows = np.ones(got[0].shape[:2], bool)
    atol = 1e-5
    if c["grid"] is not None:
        _, d = camera_rays(CAM, c["h"], c["w"], "cpu")
        (t0, t1), _, _ = _image_ray_ranges(c["grid"], torch.from_numpy(CAM.position), d,
                                           torch.tensor(CAM.near), torch.tensor(CAM.far),
                                           c["cfg"])
        _, jd = jax_camera_rays(JCAM, c["h"], c["w"])
        jgrid = jax_accel.OccupancyGrid(occ=jnp.asarray(c["occ"]),
                                        aabb_min=jnp.full((3,), -2.0, jnp.float32),
                                        aabb_max=jnp.full((3,), 2.0, jnp.float32))
        (j0, j1), _, _ = jax_image_ray_ranges(jgrid, jnp.asarray(CAM.position), jd,
                                              jnp.asarray(CAM.near), jnp.asarray(CAM.far),
                                              JaxRenderConfig(**c["jax_cfg"]))
        t0, t1 = (x.numpy().reshape(rows.shape) for x in (t0, t1))
        j0, j1 = (np.asarray(x).reshape(rows.shape) for x in (j0, j1))
        rows = (np.abs(t0 - j0) <= 1e-6) & (np.abs(t1 - j1) <= 1e-6)
        assert rows.mean() >= 0.95
        rows &= t1 > t0
        if c["cfg"].sampling_impl == "pallas":
            atol = 2e-3
    assert rows.mean() > 0.05
    for g, w, tol in zip(got, want, (atol, 1e-4, atol)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[rows], w[rows], atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", FRAMES + ["multihost"])
def test_one_all_gather_per_frame(world2, name):
    """Every frame makes exactly one collective on every rank: the
    all-gather of the rows (the culled frame's packed order and hit count
    are computed alike on every rank)."""
    for rank in world2:
        assert rank[name]["counts"] == {"all_gather_into_tensor": 1}, (name, rank[name]["counts"])


def test_render_image_multihost_on_rank_0_only(world2):
    """render_image_multihost: the frame on rank 0, None on rank 1; the
    frame is render_image's."""
    want = single_device("plain")
    assert torch.equal(world2[0]["multihost"]["out"], want)
    assert world2[1]["multihost"]["out"] is None and world2[1]["multihost"]["error"] is None


def test_world_joined_from_torchrun_variables(world2):
    """initialize() with no arguments, from WORLD_SIZE/RANK/MASTER_ADDR/
    MASTER_PORT, returns True; make_mesh("cpu") is the world of 2 on the
    CPU."""
    for r, rank in enumerate(world2):
        assert rank["initialize"] is True
        assert rank["mesh"] == (2, r, "cpu")


def test_gloo_world_defaults_each_rank_to_its_card(world2):
    """make_mesh() with no device named puts each rank on cuda:$LOCAL_RANK,
    under gloo too: the CPU only when it is named."""
    for r, rank in enumerate(world2):
        assert rank["default_device"] == f"cuda:{r}"


def test_culled_frames_render_extra_rays_only_as_the_unpacked_frame_does(world2):
    """The sharded culled frame pads each rank's share of the hit rays to
    whole chunks, so it renders more culled rays than the single-device
    packed frame. With box placement (mask-only, or bench.py's probe
    culling) a culled ray composites to exactly the background, so the two
    frames are bitwise equal (above). Probe culling without placement
    renders such a ray over [near, far]: it is then not background, and
    the bar is the packed-against-unpacked contract
    (tests/test_torch_accel.py): hit rays bitwise, every other ray the
    background or the unpacked frame's."""
    c = CASES["culled_off_probes"]
    got = world2[0]["culled_off_probes"]["out"]
    assert torch.equal(got, world2[1]["culled_off_probes"]["out"])
    packed = single_device("culled_off_probes")
    unpacked = render_image(c["coarse"], c["fine"], CAM, c["h"], c["w"],
                            random.key(c["seed"], "cpu"), c["cfg"].replace(accel_cull_rays=False),
                            device="cpu", grid=c["grid"])
    _, d = camera_rays(CAM, c["h"], c["w"], "cpu")
    (t0, t1), _, _ = _image_ray_ranges(c["grid"], torch.from_numpy(CAM.position), d,
                                       torch.tensor(CAM.near), torch.tensor(CAM.far), c["cfg"])
    hit = (t1 > t0).reshape(c["h"], c["w"])
    assert 0 < int(hit.sum()) < hit.numel()
    assert torch.equal(got[hit], packed[hit]) and torch.equal(got[hit], unpacked[hit])
    white = (got == 1.0).all(-1)
    assert bool((white | (got == unpacked).all(-1))[~hit].all())
    # The finding: more culled rays are rendered than in the packed frame.
    assert int((~white & ~hit).sum()) > int(((packed != 1.0).any(-1) & ~hit).sum())


@pytest.mark.parametrize("n, size", [(256, 2), (1025, 8), (1025, 2), (65536, 3), (100, 8),
                                     (640000, 4)])
def test_process_ray_slice_matches_jax_layout(n, size, monkeypatch):
    """process_ray_slice and effective_chunk against JAX's, with JAX's
    device and process counts set to one device a process."""
    cfg, jcfg = RenderConfig(ray_chunk=192), JaxRenderConfig(ray_chunk=192)
    assert effective_chunk(n, size, cfg) == jax_effective_chunk(n, size, jcfg)
    monkeypatch.setattr(jax, "device_count", lambda: size)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    covered = []
    for rank in range(size):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        got = multihost.process_ray_slice(n, cfg, Mesh(size=size, rank=rank,
                                                       device=torch.device("cpu")))
        assert got == jax_multihost.process_ray_slice(n, jcfg), (rank, got)
        covered.extend(range(n)[got])
    assert covered == list(range(n))


def test_initialize_without_a_world_does_nothing(monkeypatch):
    """No arguments and no torchrun variables: nothing is attempted, no
    process group exists, and make_mesh is a world of 1 on the card
    (without a group, so no collective runs)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.device, mesh.group) == (1, 0, torch.device("cuda"), None)


@pytest.fixture
def world1(tmp_path):
    """A world of 1 in this process (gloo, a file:// store), torn down
    after the test."""
    assert multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu",
                                timeout=datetime.timedelta(seconds=60)) is False
    try:
        yield make_mesh("cpu")
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_world_of_1_defaults_to_the_card(world1, monkeypatch):
    """In a gloo world make_mesh() with no device named, or with "cuda",
    is cuda:$LOCAL_RANK (cuda:0 without it); the CPU only when named.
    Nothing is launched."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert make_mesh().device == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert make_mesh().device == make_mesh("cuda").device == torch.device("cuda", 3)
    assert make_mesh("cuda:1").device == torch.device("cuda", 1)
    assert make_mesh("cpu").device == torch.device("cpu")


@contextlib.contextmanager
def counted(monkeypatch, names):
    counts = {}
    for name in names:
        real = getattr(dist, name)

        def wrapped(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(dist, name, wrapped)
    yield counts


@pytest.mark.parametrize("name", ["plain", "aux", "culled_aabb"])
def test_world_of_1_frame_is_bitwise_render_image(world1, monkeypatch, name):
    """In a world of 1 the all-gather is the identity: the sharded frame is
    render_image's bit for bit, with one all-gather."""
    assert (world1.size, world1.rank, world1.device) == (1, 0, torch.device("cpu"))
    c = CASES[name]
    fn = render_image_aux_sharded if c["kind"] == "aux" else render_image_sharded
    op = "all_gather_into_tensor"
    with counted(monkeypatch, [op, "all_reduce", "broadcast", "barrier"]) as counts:
        got = fn(c["coarse"], c["fine"], CAM, c["h"], c["w"], random.key(c["seed"], "cpu"),
                 c["cfg"], mesh=world1, grid=c["grid"])
    assert counts == {op: 1}
    for g, w in zip(as_tuple(got), as_tuple(single_device(name))):
        assert torch.equal(g, w)


def test_sweeps_of_a_numpy_tree_default_to_the_card():
    """A tree of numpy arrays (io.weights.load_nerf_params's) lives on no
    device, so build_occupancy_grid, density_grid, build_scene_grid,
    vertex_colors and extract_scene_mesh run it on the card unless a device
    is named; a tensor tree or a module runs where it is. Nothing is
    launched here."""
    tree = np_params(SMALL, 30)
    assert accel._params_device(tree) == torch.device("cuda")
    assert accel._params_device(np_hash_tree(40)) == torch.device("cuda")
    tensors = {k: {p: torch.from_numpy(a) for p, a in v.items()} for k, v in tree.items()}
    assert accel._params_device(tensors) == torch.device("cpu")
    assert accel._params_device(hg.HashGridField(np_hash_tree(40))) == torch.device("cpu")
