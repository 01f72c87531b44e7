"""Multi-device image rendering: the frame's rays split over the ranks.

The JAX package shards one flat ray axis over every chip of a mesh with
``shard_map``; each chip runs the single-device chunked render. Here each
rank of the ``torch.distributed`` world renders its contiguous rows of the
padded ray axis through ``render._render_flat`` (the kernels included),
and one all-gather (``mesh.all_gather_rows``) gives every rank the whole
frame, as JAX's single process holds it. The networks are replicated; the
render itself needs no collective.

Every ray draws from the stream of its global index (``render_rays``'s
``ray_ids``), so the sharded frame is bitwise the single-device frame, with
one exception: under ``cfg.accel_cull_rays`` with probes
(``accel_aabb_probes``) and without ``accel_sample_aabb``, the culled frame
renders padding rays that the single-device packed frame leaves as the
background. There only the rays that hit the grid are bitwise; every other
ray is the background or the unpacked frame's, the packed-against-unpacked
contract.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.ops.rays import Camera
from nerf_rs_tpu_torch.parallel.mesh import Mesh, all_gather_rows, make_mesh
from nerf_rs_tpu_torch.render import (
    _image_ray_ranges,
    _image_setup,
    _pack_rays,
    _pad_rays,
    _render_flat,
    _round_up,
    _scatter_packed,
    render_rays,
)


def effective_chunk(n_rays: int, n_devices: int, cfg: RenderConfig) -> int:
    """The per-rank chunk the sharded render uses; pass it to
    ``accel.suggest_capacities`` / ``calibrate_capacities`` so that
    capacity tuning sees the same chunks. The rows a rank renders are a
    multiple of it."""
    return min(cfg.ray_chunk, _round_up(max(n_rays // n_devices, 1), 128))


def _setup(params_coarse, params_fine, camera, height, width, key, cfg, mesh, grid):
    """The networks, key, grid, origin and flat dirs on the rank's device,
    the effective chunk and the rows a rank renders."""
    coarse, fine, key, grid, origin, dirs, _ = _image_setup(
        params_coarse, params_fine, camera, height, width, key, cfg, mesh.device, grid)
    n = height * width
    chunk = effective_chunk(n, mesh.size, cfg)
    return coarse, fine, key, grid, origin, dirs, chunk, _round_up(-(-n // mesh.size), chunk)


def render_flat_sharded(params_coarse, params_fine, camera: Camera, height: int, width: int,
                        key: torch.Tensor, cfg: Optional[RenderConfig] = None,
                        mesh: Optional[Mesh] = None, grid=None):
    """This rank's rows of the frame -> ((n_per_dev, 3) rgb, n): rows
    ``[rank * n_per_dev, (rank + 1) * n_per_dev)`` of the ray axis padded
    to ``n_per_dev * size``, ``n_per_dev`` a multiple of
    :func:`effective_chunk`, each ray keyed by its global index."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    coarse, fine, key, grid, origin, dirs, chunk, n_per_dev = _setup(
        params_coarse, params_fine, camera, height, width, key, cfg, mesh, grid)
    n = height * width
    base = mesh.rank * n_per_dev
    rows = _pad_rays(dirs.reshape(n, 3), n_per_dev * mesh.size)[base:base + n_per_dev]
    with torch.no_grad():
        rgb = _render_flat(coarse, fine, origin, rows, camera.near, camera.far, key, cfg,
                           ray_id_base=base, chunk=chunk, grid=grid)
    return rgb, n


def render_image_sharded(params_coarse, params_fine, camera: Camera, height: int, width: int,
                         key: torch.Tensor, cfg: Optional[RenderConfig] = None,
                         mesh: Optional[Mesh] = None, grid=None) -> torch.Tensor:
    """Render (height, width, 3) with the rays split over the ranks; every
    rank returns the whole frame, bitwise ``render.render_image``'s (but
    for the culled frame's exception in the module docstring).
    ``grid`` (``accel.OccupancyGrid``) is used on every rank; with
    ``cfg.accel_cull_rays`` the rays that can hit it are packed first and
    the packed prefix is split (:func:`_render_image_culled_sharded`)."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    if grid is not None and cfg.accel_cull_rays:
        return _render_image_culled_sharded(params_coarse, params_fine, camera, height, width,
                                            key, cfg, mesh, grid)
    rgb, n = render_flat_sharded(params_coarse, params_fine, camera, height, width, key, cfg,
                                 mesh=mesh, grid=grid)
    return all_gather_rows(mesh, rgb)[:n].reshape(height, width, 3)


def _render_image_culled_sharded(params_coarse, params_fine, camera, height, width, key, cfg,
                                 mesh, grid):
    """Ray-culled sharded frame: every rank computes the same packed order
    and hit count (so no collective is needed for them), renders its share
    ``n_per_dev = min(round_up(ceil(n_hit / size), chunk), dense rows a
    rank)`` of the packed prefix, wrapped modulo the frame when it runs
    past it (duplicates render the same values: same ray id, same stream),
    and the gathered colours are scattered over a background frame. Each
    rank renders about hits / size rays instead of n / size."""
    coarse, fine, key, grid, origin, dirs, chunk, dense_per_dev = _setup(
        params_coarse, params_fine, camera, height, width, key, cfg, mesh, grid)
    n = height * width
    near = torch.as_tensor(camera.near, dtype=torch.float32, device=dirs.device)
    far = torch.as_tensor(camera.far, dtype=torch.float32, device=dirs.device)
    with torch.no_grad():
        (t0, t1), order, n_hit = _image_ray_ranges(grid, origin, dirs, near, far, cfg)
        n_hit = max(int(n_hit), 1)                      # the one host sync
        n_per_dev = min(_round_up(-(-n_hit // mesh.size), chunk), dense_per_dev)
        wrapped = order[torch.arange(n_per_dev * mesh.size, device=order.device) % n]
        base = mesh.rank * n_per_dev
        mine = wrapped[base:base + n_per_dev]
        _, dirs_mine, ranges = _pack_rays(t0, t1, mine, dirs.reshape(n, 3), n_per_dev,
                                          cfg.accel_sample_aabb)
        rgb = _render_flat(coarse, fine, origin, dirs_mine, camera.near, camera.far, key, cfg,
                           chunk=chunk, grid=grid, ray_ids_flat=mine, ray_ranges_flat=ranges)
        out = _scatter_packed(all_gather_rows(mesh, rgb), wrapped, n, cfg.white_background)
    return out.reshape(height, width, 3)


def render_image_aux_sharded(params_coarse, params_fine, camera: Camera, height: int,
                             width: int, key: torch.Tensor, cfg: Optional[RenderConfig] = None,
                             mesh: Optional[Mesh] = None, grid=None):
    """Sharded ``render.render_image_aux``: (rgb (H, W, 3), depth (H, W),
    acc (H, W)) with the rays split over the ranks, the three maps gathered
    in one all-gather; bitwise the single-device maps."""
    cfg = cfg or RenderConfig()
    mesh = mesh or make_mesh()
    coarse, fine, key, grid, origin, dirs, chunk, n_per_dev = _setup(
        params_coarse, params_fine, camera, height, width, key, cfg, mesh, grid)
    n = height * width
    base = mesh.rank * n_per_dev
    rows = _pad_rays(dirs.reshape(n, 3), n_per_dev * mesh.size)[base:base + n_per_dev]
    parts = []
    with torch.no_grad():
        for s in range(0, n_per_dev, chunk):
            d = rows[s:s + chunk]
            ids = base + s + torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
            rgb, aux = render_rays(coarse, fine, origin, d, camera.near, camera.far, key, cfg,
                                   ray_ids=ids, grid=grid, return_aux=True)
            parts.append(torch.cat([rgb, aux["depth"][:, None], aux["acc"][:, None]], dim=-1))
        maps = all_gather_rows(mesh, torch.cat(parts))[:n]
    return (maps[:, :3].reshape(height, width, 3), maps[:, 3].reshape(height, width),
            maps[:, 4].reshape(height, width))
