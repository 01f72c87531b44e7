"""Occupancy-grid acceleration: empty-space skipping for inference.

A conservative density grid over the scene box tells the renderer where
nothing is, so it can skip work there:

- :func:`build_occupancy_grid` sweeps the network's sigma at the cell
  centers (through the fused MLP kernel, bf16, sigma-only, by default),
  thresholds it and dilates by one cell (3^3 max-pool), so the grid
  over-approximates occupancy; :func:`build_scene_grid` takes the union of
  the coarse and fine networks' grids;
- :func:`query_occupancy` looks points up (nearest cell; out of the box is
  empty);
- :func:`ray_aabb_range`, :func:`ray_occupied_range` and
  :func:`strided_ray_ranges` give each ray the span of t where it can meet
  matter: the chord through the occupied cells' box, the run between its
  first and last occupied probe, or probes on a strided sub-grid of the
  image widened by a 3x3 neighbourhood;
- :func:`compact_apply` evaluates a function at the masked rows only,
  through a fixed-capacity buffer ("scatter" or "gather" compaction).

A skipped sample contributes sigma = 0 exactly. The functions are those of
``nerf_rs_tpu/accel.py``, on tensors; :func:`grid_from_numpy` hands one
numpy grid to the port, as the tests hand it to both packages.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class OccupancyGrid(NamedTuple):
    occ: torch.Tensor        # (R, R, R) bool
    aabb_min: torch.Tensor   # (3,) f32
    aabb_max: torch.Tensor   # (3,) f32

    @property
    def resolution(self) -> int:
        return self.occ.shape[0]

    def to(self, device) -> "OccupancyGrid":
        return OccupancyGrid(*(x.to(device) for x in self))


def grid_from_numpy(occ, aabb_min, aabb_max, device) -> OccupancyGrid:
    """An OccupancyGrid on ``device`` from a numpy (R, R, R) occupancy and
    the box corners (scalars or (3,))."""
    def corner(v):
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (3,)).copy(),
                               device=device)

    return OccupancyGrid(occ=torch.as_tensor(np.asarray(occ, bool), device=device),
                         aabb_min=corner(aabb_min), aabb_max=corner(aabb_max))


def _fused_sigma(params, pts, dirs):
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

    return fused_nerf_mlp(params, pts, dirs, sigma_only=True, dtype="bfloat16")


def _oracle_sigma(params, pts, dirs):
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    return nerf_mlp(params, pts, dirs, sigma_only=True)


def _default_mlp_fn(params) -> Callable:
    """The fused kernel in bf16, sigma-only, for the archs it serves; the
    plain oracle for any other."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import supports_arch

    return _fused_sigma if supports_arch(params) else _oracle_sigma


def _params_device(params) -> torch.device:
    """Where a sweep of ``params`` runs by default: a module's or a tensor
    tree's own device; the card for a tree of numpy arrays (as
    ``io.weights.load_nerf_params`` returns), which lives on no device."""
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    leaf = params["hash_tables"] if "hash_tables" in params else params["dense0"]["kernel"]
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cuda")


def _cell_centers(resolution: int, aabb, device) -> torch.Tensor:
    lo, hi = float(aabb[0]), float(aabb[1])
    r = resolution
    c = lo + (torch.arange(r, dtype=torch.float32, device=device) + 0.5) * ((hi - lo) / r)
    gx, gy, gz = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)        # (r^3, 3)


def _grid_sweep(params, pts, sigma_threshold: float, *, mlp_fn, chunk: int, r: int,
                dilate: int, return_sigma: bool = False):
    """Sigma at ``pts`` in chunks -> thresholded grid dilated ``dilate``
    times by a 3^3 max-pool (and the raw lattice with ``return_sigma``)."""
    dirs = torch.zeros((1, 3), dtype=torch.float32, device=pts.device)
    dirs[0, 2] = 1.0                                  # sigma ignores dirs
    with torch.no_grad():
        sig = torch.cat([mlp_fn(params, pts[s:s + chunk].contiguous(), dirs)[1].reshape(-1)
                         for s in range(0, pts.shape[0], chunk)])
        occ = (sig > sigma_threshold).reshape(r, r, r)
        for _ in range(dilate):
            occ = F.max_pool3d(occ[None, None].to(torch.float32), 3, stride=1,
                               padding=1)[0, 0] > 0
    if return_sigma:
        return occ, sig.reshape(r, r, r)
    return occ


def field_grid_kwargs(cfg) -> dict:
    """``build_scene_grid`` arguments that sweep the configured field
    itself: ``render.get_mlp_fn(cfg)`` sigma-only, so the configured impl
    and dtype (not the default bf16 sweep), and for the hash-grid family
    its own AABB. Training refreshes its grid from the student this way."""
    from nerf_rs_tpu_torch.render import get_mlp_fn

    mlp = get_mlp_fn(cfg)

    def sigma_fn(params, points, viewdirs):
        return mlp(params, points, viewdirs, sigma_only=True)

    return {"mlp_fn": sigma_fn, **({"aabb": cfg.hash.aabb} if cfg.model == "hashgrid" else {})}


def hashgrid_grid_kwargs(cfg) -> dict:
    """:func:`field_grid_kwargs` of a hash-grid RenderConfig, under the JAX
    package's name: a hash-grid field needs them wherever it is swept,
    since the default sweep assumes the MLP family and the (-2, 2) box."""
    return field_grid_kwargs(cfg)


def build_occupancy_grid(params, *, resolution: int = 128,
                         aabb: Tuple[float, float] = (-2.0, 2.0),
                         sigma_threshold: float = 0.01, dilate: int = 1,
                         chunk: int = 262_144, mlp_fn: Optional[Callable] = None,
                         device=None) -> OccupancyGrid:
    """Dense sigma sweep at cell centers -> thresholded, dilated bool grid,
    on ``device`` (default: the params' device; the card for a tree of
    numpy arrays).

    ``params`` is a param tree or a module; ``mlp_fn(params, points,
    viewdirs) -> (rgb, sigma)`` defaults to the fused kernel's bf16
    sigma-only path for the archs it serves, else the plain oracle. A
    hash-grid field takes its sweep from :func:`hashgrid_grid_kwargs`.
    """
    from nerf_rs_tpu_torch.models.mlp import as_module

    device = torch.device(device) if device is not None else _params_device(params)
    params = as_module(params, device)
    mlp_fn = mlp_fn or _default_mlp_fn(params)
    lo, hi = float(aabb[0]), float(aabb[1])
    occ = _grid_sweep(params, _cell_centers(resolution, aabb, device), sigma_threshold,
                      mlp_fn=mlp_fn, chunk=min(chunk, resolution ** 3), r=resolution,
                      dilate=dilate)
    return OccupancyGrid(occ=occ,
                         aabb_min=torch.full((3,), lo, dtype=torch.float32, device=device),
                         aabb_max=torch.full((3,), hi, dtype=torch.float32, device=device))


def density_grid(params, *, resolution: int = 128, aabb: Tuple[float, float] = (-2.0, 2.0),
                 chunk: int = 262_144, mlp_fn: Optional[Callable] = None,
                 device=None) -> torch.Tensor:
    """Raw sigma lattice at cell centers, (R, R, R) f32: the sweep of
    :func:`build_occupancy_grid` without the threshold."""
    from nerf_rs_tpu_torch.models.mlp import as_module

    device = torch.device(device) if device is not None else _params_device(params)
    params = as_module(params, device)
    mlp_fn = mlp_fn or _default_mlp_fn(params)
    _, sig = _grid_sweep(params, _cell_centers(resolution, aabb, device), 0.0, mlp_fn=mlp_fn,
                         chunk=min(chunk, resolution ** 3), r=resolution, dilate=0,
                         return_sigma=True)
    return sig


def build_scene_grid(params_coarse, params_fine, **kw) -> OccupancyGrid:
    """Union occupancy of the coarse AND fine networks: the fine pass is
    culled by this grid too, and the two networks disagree slightly about
    surface extents. One network given for both passes (a hash-grid field)
    is swept once."""
    gc = build_occupancy_grid(params_coarse, **kw)
    gf = gc if params_fine is params_coarse else build_occupancy_grid(params_fine, **kw)
    return OccupancyGrid(occ=gc.occ | gf.occ, aabb_min=gc.aabb_min, aabb_max=gc.aabb_max)


def query_occupancy(grid: OccupancyGrid, points: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (...) bool: is the containing cell occupied?
    Out-of-box points are unoccupied."""
    r = grid.resolution
    scale = r / (grid.aabb_max - grid.aabb_min)
    ijk = torch.floor((points - grid.aabb_min) * scale).to(torch.int64)
    in_bounds = torch.all((ijk >= 0) & (ijk < r), dim=-1)
    ijk = torch.clamp(ijk, 0, r - 1)
    flat = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
    return grid.occ.reshape(-1)[flat] & in_bounds


def occupied_aabb(grid: OccupancyGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tight world-space box of the occupied cells, (lo, hi) each (3,). An
    empty grid gives an inverted box (lo > hi)."""
    r = grid.resolution
    cell = (grid.aabb_max - grid.aabb_min) / r
    idx = torch.arange(r, dtype=torch.float32, device=grid.occ.device)
    axes = [grid.occ.any(dim=d) for d in ((1, 2), (0, 2), (0, 1))]
    first = torch.stack([torch.where(a, idx, float(r)).min() for a in axes])
    last = torch.stack([torch.where(a, idx, -1.0).max() for a in axes])
    return grid.aabb_min + first * cell, grid.aabb_min + (last + 1.0) * cell


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def ray_aabb_range(grid: OccupancyGrid, origin: torch.Tensor, dirs: torch.Tensor, near, far,
                   pad_cells: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray sample range [t0, t1]: the ray's chord through the occupied
    cells' box padded by ``pad_cells`` cells (slab test), clamped to
    [near, far]. Rays that miss get t1 == t0. Returns (t0, t1) each
    (*batch, 1); origin is (3,) or (*batch, 3)."""
    lo, hi = occupied_aabb(grid)
    # An empty grid's inverted box would re-sort into a spurious range.
    is_empty = torch.any(lo > hi)
    cell = (grid.aabb_max - grid.aabb_min) / grid.resolution
    lo = lo - pad_cells * cell
    hi = hi + pad_cells * cell
    tiny = torch.where(dirs < 0, -1e-9, 1e-9).to(dirs.dtype)
    safe = torch.where(torch.abs(dirs) < 1e-9, tiny, dirs)
    inv = 1.0 / safe
    ta = (lo - origin) * inv
    tb = (hi - origin) * inv
    tmin = torch.amax(torch.minimum(ta, tb), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(ta, tb), dim=-1, keepdim=True)
    near, far = _f32(near, dirs), _f32(far, dirs)
    t0 = torch.minimum(torch.maximum(tmin, near), far)
    t1 = torch.minimum(torch.maximum(tmax, t0), far)   # misses collapse to t1 == t0
    return t0, torch.where(is_empty, t0, t1)


def _linspace01(count: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, count)`` in float32, bit for bit: i times the
    float32 reciprocal of count - 1 (XLA turns the division by a constant
    into that product), and an exact 1 at the end. ``torch.linspace``
    rounds otherwise, and the probes' occupancy flips with an ulp at a
    cell boundary."""
    if count == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    idx = torch.arange(count - 1, dtype=torch.float32, device=device)
    steps = idx * torch.tensor(np.float32(1.0) / np.float32(count - 1), device=device)
    return torch.cat([steps, torch.ones(1, dtype=torch.float32, device=device)])


def ray_occupied_range(grid: OccupancyGrid, origin: torch.Tensor, dirs: torch.Tensor, near, far,
                       *, probes: int = 128, pad_probes: float = 1.0,
                       pad_cells: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray [t0, t1] spanning the ray's first..last occupied probe:
    ``probes`` equally spaced lookups along the :func:`ray_aabb_range`
    span, padded by ``pad_probes`` probe intervals on each side. Rays with
    no occupied probe collapse to a point."""
    t0, t1 = ray_aabb_range(grid, origin, dirs, near, far, pad_cells=pad_cells)
    ts = t0 + (t1 - t0) * _linspace01(probes, dirs.device)        # (*batch, P)
    pts = origin[..., None, :] + dirs[..., None, :] * ts[..., :, None]
    occ = query_occupancy(grid, pts)
    idx = torch.arange(probes, dtype=torch.float32, device=dirs.device)
    first = torch.where(occ, idx, float(probes)).amin(dim=-1, keepdim=True)
    last = torch.where(occ, idx, -1.0).amax(dim=-1, keepdim=True)
    step = (t1 - t0) / (probes - 1)
    r0 = torch.minimum(torch.maximum(t0 + (first - pad_probes) * step, t0), t1)
    r1 = torch.minimum(torch.maximum(t0 + (last + pad_probes) * step, r0), t1)
    no_hit = first > last
    return torch.where(no_hit, t0, r0), torch.where(no_hit, t0, r1)


def strided_ray_ranges(grid: OccupancyGrid, origin: torch.Tensor, dirs_img: torch.Tensor, near,
                       far, *, stride: int, probes: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray occupied ranges probed on one ray per ``stride`` x
    ``stride`` block (its center), then widened conservatively: each
    block takes the earliest entry and latest exit of its 3x3
    neighbourhood (a max-pool, and a min-pool as -max(-x), both padded
    with -inf so the image border adds nothing) and passes it to every
    pixel of the block.

    dirs_img: (H, W, 3) unit directions. Returns (t0, t1) each (H*W, 1).
    """
    h, w = dirs_img.shape[:2]
    s = int(stride)
    if s <= 1:
        return ray_occupied_range(grid, origin, dirs_img.reshape(-1, 3), near, far,
                                  probes=probes)
    dev = dirs_img.device
    iy = torch.clamp(torch.arange(-(-h // s), device=dev) * s + s // 2, max=h - 1)
    ix = torch.clamp(torch.arange(-(-w // s), device=dev) * s + s // 2, max=w - 1)
    dirs_c = dirs_img[iy][:, ix]                        # (hs, ws, 3) block centers
    hs, ws = dirs_c.shape[:2]
    t0c, t1c = ray_occupied_range(grid, origin, dirs_c.reshape(-1, 3), near, far, probes=probes)

    def pool(x):
        return F.max_pool2d(x.reshape(1, 1, hs, ws), 3, stride=1, padding=1)[0, 0]

    t0p = -pool(-t0c)
    t1p = pool(t1c)

    def expand(x):
        return x.repeat_interleave(s, 0)[:h].repeat_interleave(s, 1)[:, :w]

    t0f, t1f = expand(t0p), expand(t1p)
    t1f = torch.maximum(t1f, t0f)
    return t0f.reshape(-1, 1), t1f.reshape(-1, 1)


def compact_apply(fn: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]], rows: torch.Tensor,
                  mask: torch.Tensor, capacity: int, fills: Tuple, impl: str = "scatter"):
    """Apply ``fn`` to the masked rows of ``rows`` (N, F) only.

    Masked rows are compacted into a (capacity, F) buffer (rows past
    ``capacity`` overflow to their ``fill``), ``fn`` maps the buffer, and
    the results go back to full shape. Returns (outputs..., n_live), each
    output (N, ...); ``fills`` gives the value of masked-off and
    overflowed rows. ``n_live`` is the TRUE number of masked rows, which
    may exceed ``capacity`` (the overflow signal).

    ``impl``: "scatter" writes the rows to their slots; "gather" finds the
    j-th live row by binary search over the running count.
    """
    n = rows.shape[0]
    mask = mask.reshape(n)
    csum = torch.cumsum(mask.to(torch.int64), dim=0)   # inclusive live count
    pos = csum - 1
    live_total = csum[-1]
    dest = torch.where(mask & (pos < capacity), pos, capacity)    # capacity = trash slot
    if impl == "gather":
        slots = torch.arange(1, capacity + 1, dtype=csum.dtype, device=rows.device)
        src = torch.searchsorted(csum, slots, side="left")
        valid = (torch.arange(capacity, device=rows.device) < live_total)[:, None]
        buf = torch.where(valid, rows[torch.clamp(src, max=n - 1)], torch.zeros((), dtype=rows.dtype,
                                                                              device=rows.device))
        outs = fn(buf)
    else:
        buf = torch.zeros((capacity + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
        buf[dest] = rows
        outs = fn(buf[:capacity])
    keep = dest < capacity
    gathered = []
    for out, fill in zip(outs, fills):
        g = out[torch.clamp(dest, max=capacity - 1)]
        k = keep.reshape((n,) + (1,) * (out.dim() - 1))
        gathered.append(torch.where(k, g, torch.as_tensor(fill, dtype=g.dtype, device=g.device)))
    return (*gathered, live_total)


def capacities_from_occupancy(frac: float, cfg, *, margin_coarse: float = 2.2,
                              margin_fine: float = 1.15, quantum: float = 0.125):
    """Heuristic (cap_coarse, cap_fine) from a volume-occupancy fraction,
    floored at the cfg defaults and quantized to ``quantum`` steps."""
    def up(v: float) -> float:
        return min(1.0, -(-v // quantum) * quantum)

    cap_c = max(cfg.accel_coarse_capacity, up(margin_coarse * frac))
    nc, nf = cfg.n_coarse, cfg.n_fine
    cap_f = max(cfg.accel_fine_capacity, up(margin_fine * (cap_c * nc + nf) / (nc + nf)))
    return cap_c, cap_f


def _padded_dirs(camera, height: int, width: int, chunk: int, device):
    """The frame's flat dirs padded as ``render_image`` pads them."""
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.render import _pad_rays

    _, dirs = camera_rays(camera, height, width, device)
    return _pad_rays(dirs.reshape(height * width, 3), chunk)


def suggest_capacities(grid: OccupancyGrid, camera, height: int, width: int, cfg,
                       margin: float = 1.3, chunk: Optional[int] = None):
    """Chunk-safe capacity fractions from geometry alone: the image's rays
    in render_image's chunking, each coarse bin at its midpoint, looked up
    in the grid (no MLP). The coarse capacity is the worst chunk's occupied
    fraction times ``margin``; the fine one that chunk's bound with every
    fine sample occupied. Returns ``cfg`` with both replaced."""
    n = height * width
    chunk = chunk or min(cfg.ray_chunk, max(n, 1))
    device = grid.occ.device
    dirs_flat = _padded_dirs(camera, height, width, chunk, device)
    near, far = float(camera.near), float(camera.far)
    mids = near + (torch.arange(cfg.n_coarse, dtype=torch.float32, device=device) + 0.5) * (
        (far - near) / cfg.n_coarse)
    origin = torch.as_tensor(np.asarray(camera.position), dtype=torch.float32, device=device)
    fracs = []
    for d in dirs_flat.reshape(-1, chunk, 3):
        pts = origin + d[:, None, :] * mids[None, :, None]
        fracs.append(torch.mean(query_occupancy(grid, pts).to(torch.float32)))
    worst = float(torch.stack(fracs).max())
    coarse = min(1.0, margin * worst + 1e-3)
    fine_ub = (worst * cfg.n_coarse + cfg.n_fine) / (cfg.n_coarse + cfg.n_fine)
    return cfg.replace(accel_coarse_capacity=coarse,
                       accel_fine_capacity=min(1.0, margin * fine_ub))


def calibrate_capacities(params_coarse, params_fine, grid: OccupancyGrid, camera, height: int,
                         width: int, key, cfg, margin: float = 1.15,
                         chunk: Optional[int] = None):
    """Measure, then tighten, the capacity fractions: one render at
    capacity 1.0 records the worst chunk's true live sample counts of both
    passes; the capacities become measured / maximum x ``margin``. The
    render uses render_image's padded flat layout and chunking (``chunk``
    overrides it). Returns ``cfg`` with both replaced."""
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.render import _render_flat

    n = height * width
    chunk = chunk or min(cfg.ray_chunk, max(n, 1))
    device = grid.occ.device
    wide = cfg.replace(accel_coarse_capacity=1.0, accel_fine_capacity=1.0)
    dirs_flat = _padded_dirs(camera, height, width, chunk, device)
    origin = torch.as_tensor(np.asarray(camera.position), dtype=torch.float32, device=device)
    with torch.no_grad():
        _, (live_c, live_f) = _render_flat(
            as_module(params_coarse, device), as_module(params_fine, device), origin, dirs_flat,
            camera.near, camera.far, key.to(device), wide, chunk=chunk, grid=grid,
            return_live=True)
    coarse = min(1.0, margin * float(live_c) / (chunk * cfg.n_coarse))
    fine = min(1.0, margin * float(live_f) / (chunk * (cfg.n_coarse + cfg.n_fine)))
    return cfg.replace(accel_coarse_capacity=coarse, accel_fine_capacity=fine)
