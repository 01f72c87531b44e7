"""End-to-end hierarchical NeRF rendering.

One batched program over a [num_rays, num_samples] grid:

    coarse stratified samples -> coarse MLP (sigmas only)
    -> transmittance weights -> inverse-CDF importance resampling
    -> merge + sort (fixed width Nc + Nf) -> fine MLP
    -> transmittance-weighted compositing onto a white background.

The resampling chain runs as plain ops (``sampling_impl="xla"``) or as the
fused CUDA kernel K3 (``sampling_impl="pallas"``, ``ops.kernels.resample``).
With an occupancy grid (``accel.OccupancyGrid``) the render skips empty
space: per-ray sample ranges, per-sample occupancy masks or compaction, and
at the image level the packing of the rays that can hit anything
(``accel_cull_rays``).

Image renders loop over fixed-size ray chunks on the host, the last one
padded to full size. Each ray draws from its own random stream, folded
from the render key by its global ray index, so an image does not depend on
the chunk size or on the packing order, and equals the JAX package's render
of the same key (``ops.random`` matches ``jax.random`` bit for bit).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.models.mlp import as_module, nerf_mlp
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import Camera, camera_rays
from nerf_rs_tpu_torch.ops.sampling import (
    _batched_uniform,
    importance_samples,
    merge_samples,
    stratified_samples,
)
from nerf_rs_tpu_torch.ops.volume import composite, compute_weights, exclusive_transmittance


def get_mlp_fn(cfg: RenderConfig, params=None, device=None):
    """Resolve the field network: the hash-grid family
    (``model="hashgrid"``: ``models.hashgrid.hashgrid_mlp``, whose encode is
    a CUDA kernel; ``impl`` selects kernels within the MLP family only, as
    in the JAX package), the plain PyTorch MLP (``impl="xla"``), the
    fused CUDA kernel (``impl="pallas"``), or the W8A8 family
    (``models/quant.py``, which ignores ``cfg.dtype``): real int8
    inference through the int8 CUDA kernel (``impl="int8"``) or the
    fake-quant STE forward that QAT trains through (``impl="int8qat"``).

    Given one network's ``params`` and the ``device`` it runs on, the
    choice is that network's: ``impl="int8"`` on a CUDA device for a
    network beyond the int8 kernel's envelope (``int8_mlp.supports_arch``)
    resolves to the same real-int8 arithmetic without the kernel,
    ``models.quant.int8_nerf_mlp(fake=False)``, the JAX package's int8
    path at every width, rather than to the kernel's wrapper, which
    refuses it."""
    if cfg.model == "hashgrid":
        from nerf_rs_tpu_torch.models.hashgrid import hashgrid_mlp

        return functools.partial(hashgrid_mlp, cfg=cfg.hash, dtype=cfg.dtype)
    if cfg.model != "mlp":
        raise ValueError(f"unknown model {cfg.model!r} (expected 'mlp' or 'hashgrid')")
    if cfg.impl == "pallas":
        from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

        return functools.partial(fused_nerf_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs,
                                 dtype=cfg.dtype)
    if cfg.impl == "int8":
        from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, supports_arch

        if (params is not None and torch.device(device).type == "cuda"
                and not supports_arch(params)):
            from nerf_rs_tpu_torch.models.quant import int8_nerf_mlp

            return functools.partial(int8_nerf_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs,
                                     fake=False)
        return functools.partial(fused_int8_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs)
    if cfg.impl == "int8qat":
        from nerf_rs_tpu_torch.models.quant import int8_nerf_mlp

        return functools.partial(int8_nerf_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs,
                                 fake=True)
    if cfg.impl != "xla":
        raise ValueError(f"unknown MLP impl {cfg.impl!r} "
                         "(expected 'xla', 'pallas', 'int8', or 'int8qat')")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]

    def xla_mlp(params, points, viewdirs, sigma_only: bool = False):
        rgb, sigma = nerf_mlp(params, points.to(dt), viewdirs.to(dt), x_freqs=cfg.x_freqs,
                              d_freqs=cfg.d_freqs, sigma_only=sigma_only)
        return rgb.to(torch.float32), sigma.to(torch.float32)

    return xla_mlp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _mlp_culled(mlp, params, pts, dirs_b, mask, capacity: int, sigma_only: bool,
                impl: str = "none"):
    """Evaluate the MLP at the masked sample rows only.

    ``impl == "none"``: mask-only culling — the MLP runs densely and sigma
    (and rgb) are zeroed where culled. ``"scatter"`` / ``"gather"``:
    fixed-capacity compaction (``accel.compact_apply``); culled and
    overflowed rows get sigma = 0. Returns (rgb, sigma, live count)."""
    if impl == "none":
        rgb, sigma = mlp(params, pts, dirs_b, sigma_only=sigma_only)
        sigma = torch.where(mask, sigma, 0.0)
        if rgb.dim() == mask.dim() + 1:
            rgb = torch.where(mask[..., None], rgb, 0.0)
        return rgb, sigma, torch.sum(mask.to(torch.int64))
    from nerf_rs_tpu_torch.accel import compact_apply

    batch = pts.shape[:-1]
    n = pts.numel() // 3
    rows = torch.cat([pts.reshape(n, 3), torch.broadcast_to(dirs_b, pts.shape).reshape(n, 3)],
                     dim=-1)

    def fn(buf):
        rgb, sigma = mlp(params, buf[:, :3].contiguous(), buf[:, 3:6].contiguous(),
                         sigma_only=sigma_only)
        return rgb, sigma[:, None]

    rgb, sigma, n_live = compact_apply(fn, rows, mask.reshape(n), capacity, (0.0, 0.0),
                                       impl=impl)
    return rgb.reshape(*batch, 3), sigma.reshape(batch), n_live


class _ReattachCoarseGrads(torch.autograd.Function):
    """Identity on the fused resampler's output that routes d/dt_c.

    Each t_c value passes through the kernel's merge and sort unchanged,
    so its gradient is the output cotangent at its sorted slot, found by a
    per-row ``searchsorted`` — the gradient ``torch.sort`` would route
    (ties collapse to one slot). The forward does nothing; the search runs
    only in a backward."""

    @staticmethod
    def forward(ctx, t_f, t_c):
        ctx.save_for_backward(t_f, t_c)
        return t_f.view_as(t_f)

    @staticmethod
    def backward(ctx, g):
        t_f, t_c = ctx.saved_tensors
        slot = torch.searchsorted(t_f.contiguous(), t_c.contiguous())
        return g, torch.gather(g, -1, slot)


def _reattach_coarse_grads(t_f: torch.Tensor, t_c: torch.Tensor) -> torch.Tensor:
    return _ReattachCoarseGrads.apply(t_f, t_c)


def render_rays(params_coarse, params_fine, origin: torch.Tensor, dirs: torch.Tensor,
                near, far, key: torch.Tensor, cfg: RenderConfig, *,
                ray_ids: Optional[torch.Tensor] = None, grid=None,
                return_aux: bool = False, return_live: bool = False, ray_ranges=None):
    """Render a batch of rays -> fine RGB (..., 3), differentiable in the
    networks' parameters.

    origin: (3,) shared camera origin (or (..., 3) per-ray origins); dirs:
    (..., 3) *unit* directions; near/far: scalars or 0-d tensors; key: a
    (2,) key from ``ops.random.key``. ``ray_ids`` (flat (B,) ints, dirs
    then (B, 3)) gives every ray its own random stream, folded in by its
    id, which makes renders invariant to chunking. With ``cfg.n_fine ==
    0`` the coarse field is composited directly (single pass).

    ``cfg.sampling_impl == "pallas"`` runs the resampling chain as the
    fused kernel K3 when the dirs are flat and ``return_aux`` is off. With
    ``return_aux`` the chain is the plain one: the aux dict holds the
    coarse weights, which the kernel does not return. This is the JAX
    package's routing. The kernel is forward only; its inputs are
    detached, and :class:`_ReattachCoarseGrads` gives the coarse samples
    the gradients the plain chain's sort gives them.

    ``grid`` (``accel.OccupancyGrid``) skips empty space:
    ``accel_sample_aabb`` places each ray's samples in its occupied range
    (``ray_ranges`` = (t_lo, t_hi) each (B, 1) supplies it precomputed),
    with the integrator's far capped one coarse bin past it; unless
    ``accel_compact == "off"`` samples in empty cells get sigma = 0
    (mask-only or compaction), and fine samples past the coarse estimate
    of the ray's termination are culled too.

    ``return_aux`` also returns the JAX package's aux dict (``rgb_coarse``,
    ``acc``, ``weights_coarse``, ``weights_fine``, ``t_coarse``,
    ``t_fine``, ``depth``, and ``live_frac_*`` with a grid); the coarse
    pass then runs the full network, as training needs the coarse image.
    ``return_live`` (grid only) also returns the true numbers of live
    sample rows of both passes (capacity calibration).
    """
    if cfg.sampling_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown sampling_impl {cfg.sampling_impl!r}")
    batch_shape = tuple(dirs.shape[:-1])
    n_rays = 1
    for s in batch_shape:
        n_rays *= s
    k_coarse, k_fine = random.split(key)
    if ray_ids is not None:
        if dirs.dim() != 2:
            raise ValueError("ray_ids requires flat (B, 3) dirs")
        k_coarse = random.fold_in(k_coarse, ray_ids)
        k_fine = random.fold_in(k_fine, ray_ids)
    accel = grid is not None
    if return_live and not accel:
        raise ValueError("return_live requires an occupancy grid")
    if return_live and return_aux:
        raise ValueError("return_live is incompatible with return_aux — "
                         "calibrate capacities through the inference path")
    device = dirs.device
    mlp_c, mlp_f = (get_mlp_fn(cfg, p, device) for p in (params_coarse, params_fine))
    near = torch.as_tensor(near, dtype=torch.float32, device=device)
    far = torch.as_tensor(far, dtype=torch.float32, device=device)

    # --- coarse pass ---
    t_lo, t_hi = near, far
    if accel and cfg.accel_sample_aabb:
        from nerf_rs_tpu_torch.accel import ray_aabb_range, ray_occupied_range

        if ray_ranges is not None:
            t_lo, t_hi = ray_ranges
        elif cfg.accel_aabb_probes > 0:
            t_lo, t_hi = ray_occupied_range(grid, origin, dirs, near, far,
                                            probes=cfg.accel_aabb_probes,
                                            pad_probes=cfg.accel_pad_probes)
        else:
            t_lo, t_hi = ray_aabb_range(grid, origin, dirs, near, far)
        # Placement is geometry, not a learnable quantity.
        t_lo, t_hi = t_lo.detach(), t_hi.detach()
        # Cap the integrator's far one bin past the clamped range, so the
        # last sample's delta does not reach to the camera's far.
        far_w = torch.minimum(far, t_hi + (t_hi - t_lo) / cfg.n_coarse)
    else:
        far_w = far
    t_c = stratified_samples(k_coarse, t_lo, t_hi, cfg.n_coarse, batch_shape)
    pts_c = origin[..., None, :] + dirs[..., None, :] * t_c[..., :, None]
    # The coarse colors are discarded unless single-pass or the caller
    # needs the coarse image.
    single_pass = cfg.n_fine == 0
    coarse_sigma_only = not return_aux and not single_pass
    # "off": the grid steers ray packing and sample placement only.
    mask_samples = accel and cfg.accel_compact != "off"
    if mask_samples:
        from nerf_rs_tpu_torch.accel import query_occupancy

        occ_c = query_occupancy(grid, pts_c)
        cap_c = _round_up(max(1, int(n_rays * cfg.n_coarse * cfg.accel_coarse_capacity)),
                          1024) if cfg.accel_compact != "none" else max(1, n_rays * cfg.n_coarse)
        rgb_c, sigma_c, live_c = _mlp_culled(mlp_c, params_coarse, pts_c, dirs[..., None, :], occ_c,
                                             cap_c, sigma_only=coarse_sigma_only,
                                             impl=cfg.accel_compact)
    else:
        rgb_c, sigma_c = mlp_c(params_coarse, pts_c, dirs[..., None, :],
                             sigma_only=coarse_sigma_only)
        if return_live:       # "off": every sample is live
            live_c = torch.tensor(n_rays * cfg.n_coarse, device=device)

    if single_pass:
        w_c = compute_weights(sigma_c, t_c, far_w, t_threshold=cfg.t_threshold)
        rgb = composite(rgb_c, w_c, white_background=cfg.white_background)
        if return_live:
            return rgb, (live_c, torch.zeros_like(live_c))
        if not return_aux:
            return rgb
        aux = {"rgb_coarse": rgb, "acc": torch.sum(w_c, dim=-1), "weights_coarse": w_c,
               "weights_fine": w_c, "t_coarse": t_c, "t_fine": t_c,
               "depth": torch.sum(w_c * t_c, dim=-1)}
        if mask_samples:
            aux["live_frac_coarse"] = live_c.to(torch.float32) / cap_c
            aux["live_frac_fine"] = torch.zeros_like(aux["live_frac_coarse"])
        elif accel:
            aux["live_frac_coarse"] = torch.tensor(1.0, device=device)
            aux["live_frac_fine"] = torch.tensor(0.0, device=device)
        return rgb, aux

    # --- hierarchical resampling ---
    if cfg.sampling_impl == "pallas" and not return_aux and dirs.dim() == 2:
        from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

        u = _batched_uniform(k_fine, batch_shape, cfg.n_fine)
        t_f = fused_resample(t_c.detach(), sigma_c.detach(), u, far_w.detach(),
                             t_threshold=cfg.t_threshold, pdf_eps=cfg.pdf_eps,
                             cdf_eps=cfg.cdf_eps)
        t_f = _reattach_coarse_grads(t_f, t_c)
    else:
        w_c = compute_weights(sigma_c, t_c, far_w, t_threshold=cfg.t_threshold)
        t_extra = importance_samples(k_fine, t_c, w_c, cfg.n_fine, pdf_eps=cfg.pdf_eps,
                                     cdf_eps=cfg.cdf_eps)
        t_f = merge_samples(t_c, t_extra.detach())

    # --- fine pass ---
    pts_f = origin[..., None, :] + dirs[..., None, :] * t_f[..., :, None]
    if mask_samples:
        from nerf_rs_tpu_torch.accel import query_occupancy

        # Termination culling: past the coarse estimate of where T drops
        # below accel_t_threshold, padded by accel_t_slack_bins coarse bins
        # of distance, fine samples cannot contribute.
        mask_f = query_occupancy(grid, pts_f)
        if cfg.accel_t_threshold > 0.0:
            live = exclusive_transmittance(sigma_c, t_c, far_w) >= cfg.accel_t_threshold
            slack = cfg.accel_t_slack_bins * (far - near) / cfg.n_coarse
            t_term = torch.amax(torch.where(live, t_c, near), dim=-1, keepdim=True)
            mask_f = mask_f & (t_f <= t_term + slack)
        cap_f = _round_up(max(1, int(n_rays * (cfg.n_coarse + cfg.n_fine)
                                     * cfg.accel_fine_capacity)), 1024) \
            if cfg.accel_compact != "none" else max(1, n_rays * (cfg.n_coarse + cfg.n_fine))
        rgb_f, sigma_f, live_f = _mlp_culled(mlp_f, params_fine, pts_f, dirs[..., None, :], mask_f,
                                             cap_f, sigma_only=False, impl=cfg.accel_compact)
    else:
        rgb_f, sigma_f = mlp_f(params_fine, pts_f, dirs[..., None, :])
        if return_live:
            live_f = torch.tensor(n_rays * (cfg.n_coarse + cfg.n_fine), device=device)
    w_f = compute_weights(sigma_f, t_f, far_w, t_threshold=cfg.t_threshold)
    rgb = composite(rgb_f, w_f, white_background=cfg.white_background)

    if return_live:
        return rgb, (live_c, live_f)
    if not return_aux:
        return rgb
    aux = {"rgb_coarse": composite(rgb_c, w_c, white_background=cfg.white_background),
           "acc": torch.sum(w_f, dim=-1), "weights_coarse": w_c, "weights_fine": w_f,
           "t_coarse": t_c, "t_fine": t_f, "depth": torch.sum(w_f * t_f, dim=-1)}
    if mask_samples:
        # Fraction of capacity used per pass; > 1 means samples overflowed.
        aux["live_frac_coarse"] = live_c.to(torch.float32) / cap_c
        aux["live_frac_fine"] = live_f.to(torch.float32) / cap_f
    elif accel:
        aux["live_frac_coarse"] = torch.tensor(1.0, device=device)
        aux["live_frac_fine"] = torch.tensor(1.0, device=device)
    return rgb, aux


def _render_flat(params_coarse, params_fine, origin, dirs_flat, near, far, key,
                 cfg: RenderConfig, ray_id_base: int = 0, chunk: Optional[int] = None, *,
                 grid=None, return_live: bool = False,
                 ray_ids_flat: Optional[torch.Tensor] = None,
                 ray_ranges_flat: Optional[torch.Tensor] = None):
    """Render (N, 3) unit dirs in chunks of ``chunk`` (default
    ``cfg.ray_chunk``) rays -> (N, 3). Ray ``i`` draws from the stream of
    global id ``ray_id_base + i``, or of ``ray_ids_flat[i]`` when given
    (the packed render passes each ray's image index). ``ray_ranges_flat``
    ((N, 2): t_lo, t_hi) supplies per-ray sample ranges. With
    ``return_live`` (grid only) also returns the worst chunk's live sample
    counts of both passes."""
    n = dirs_flat.shape[0]
    chunk = chunk or cfg.ray_chunk
    outs, lives = [], []
    for s in range(0, n, chunk):
        d = dirs_flat[s:s + chunk]
        if ray_ids_flat is None:
            ids = ray_id_base + s + torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
        else:
            ids = ray_ids_flat[s:s + chunk]
        ranges = None
        if ray_ranges_flat is not None:
            ranges = (ray_ranges_flat[s:s + chunk, 0:1], ray_ranges_flat[s:s + chunk, 1:2])
        out = render_rays(params_coarse, params_fine, origin, d, near, far, key, cfg,
                          ray_ids=ids, grid=grid, return_live=return_live, ray_ranges=ranges)
        if return_live:
            out, live = out
            lives.append(live)
        outs.append(out)
    rgb = torch.cat(outs, dim=0)
    if return_live:
        return rgb, tuple(torch.stack([lv[i] for lv in lives]).max() for i in range(2))
    return rgb


def _pad_rays(dirs_flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pad (N, 3) dirs with (1, 1, 1) rows to a multiple of ``chunk``, so
    that every launch of a render has the same shapes."""
    pad = (-dirs_flat.shape[0]) % chunk
    if not pad:
        return dirs_flat
    return torch.cat([dirs_flat, torch.ones((pad, 3), dtype=dirs_flat.dtype,
                                            device=dirs_flat.device)])


def _image_setup(params_coarse, params_fine, camera: Camera, height: int, width: int, key,
                 cfg: RenderConfig, device, grid):
    """The networks, key and grid on the render's device, the camera's rays
    and the chunk size. One network given for both passes (a hash-grid
    field) stays one module."""
    device = torch.device(device) if device is not None else key.device
    origin, dirs = camera_rays(camera, height, width, device)
    coarse = as_module(params_coarse, device)
    fine = coarse if params_fine is params_coarse else as_module(params_fine, device)
    return (coarse, fine, key.to(device),
            grid.to(device) if grid is not None else None, origin[0, 0], dirs,
            min(cfg.ray_chunk, max(height * width, 1)))


def _image_ray_ranges(grid, origin, dirs_img, near, far, cfg: RenderConfig):
    """Per-ray occupied ranges of a full (H, W, 3) frame, the hit-rays-first
    permutation and the hit count, for ray packing.

    A ray "hits" when its occupied range is non-degenerate: the range the
    sampler would use (probe ranges when the config samples that way, else
    the occupied-box chord). With ``accel_compact == "off"`` probe culling
    applies even without box placement: a ray with no occupied probe passes
    only through empty space. ``accel_range_stride > 1`` probes a strided
    sub-grid (``accel.strided_ray_ranges``)."""
    from nerf_rs_tpu_torch.accel import ray_aabb_range, strided_ray_ranges

    if cfg.accel_aabb_probes > 0 and (cfg.accel_sample_aabb or cfg.accel_compact == "off"):
        t0, t1 = strided_ray_ranges(grid, origin, dirs_img, near, far,
                                    stride=cfg.accel_range_stride, probes=cfg.accel_aabb_probes)
    else:
        t0, t1 = ray_aabb_range(grid, origin, dirs_img.reshape(-1, 3), near, far)
    hit = (t1 > t0).reshape(-1)
    # A stable sort of "not hit": hits first, each group in image order.
    order = torch.argsort((~hit).to(torch.uint8), stable=True)
    return (t0, t1), order, torch.sum(hit.to(torch.int64))


def _pack_rays(t0, t1, order, dirs_flat, n_render: int, want_ranges: bool):
    """The first ``n_render`` rays of ``order``, wrapped around to the
    leading (hit) rays when ``n_render`` exceeds the image: duplicates
    render to identical values (same ray id, same stream). Returns the
    packed order, dirs and, with ``want_ranges``, (t_lo, t_hi) rows."""
    n = order.shape[0]
    order_r = torch.cat([order, order[:n_render - n]]) if n_render > n else order[:n_render]
    ranges = torch.cat([t0, t1], dim=-1)[order_r] if want_ranges else None
    return order_r, dirs_flat[order_r], ranges


def _scatter_packed(rgb, order_r, n: int, white: bool) -> torch.Tensor:
    """The packed rays' colors over a background-filled (n, 3) frame."""
    out = torch.full((n, 3), 1.0 if white else 0.0, dtype=torch.float32, device=rgb.device)
    out[order_r] = rgb
    return out


def _render_image_culled(coarse, fine, origin, dirs, near, far, key, cfg: RenderConfig, grid,
                         chunk: int) -> torch.Tensor:
    """Ray-culled frame: pack the rays whose occupied range is
    non-degenerate to the front (a stable device sort; only the hit count
    crosses to the host), render ceil(hits / chunk) full chunks, and
    scatter the colors back over a background-filled frame.

    Per-ray streams are keyed by the original image index and every chunk
    has the unpacked render's shapes, so each hit ray is bitwise the
    unpacked accel render's; culled rays composite to the background the
    unpacked render gives them, to within the grid's conservativeness."""
    height, width = dirs.shape[:2]
    n = height * width
    near_t = torch.as_tensor(near, dtype=torch.float32, device=dirs.device)
    far_t = torch.as_tensor(far, dtype=torch.float32, device=dirs.device)
    (t0, t1), order, n_hit = _image_ray_ranges(grid, origin, dirs, near_t, far_t, cfg)
    n_hit = max(int(n_hit), 1)                          # the one host sync
    n_render = min(-(-n_hit // chunk) * chunk, _round_up(n, chunk))
    order_r, dirs_packed, ranges = _pack_rays(t0, t1, order, dirs.reshape(n, 3), n_render,
                                              cfg.accel_sample_aabb)
    rgb = _render_flat(coarse, fine, origin, dirs_packed, near, far, key, cfg, chunk=chunk,
                       grid=grid, ray_ids_flat=order_r, ray_ranges_flat=ranges)
    return _scatter_packed(rgb, order_r, n, cfg.white_background)


def render_image(params_coarse, params_fine, camera: Camera, height: int, width: int,
                 key: torch.Tensor, cfg: Optional[RenderConfig] = None, *, device=None,
                 grid=None, return_live: bool = False):
    """Render a full (height, width, 3) f32 image on ``device`` (default:
    the key's device). The networks are param trees or modules; both
    become modules on the device (``models.mlp.as_module``), so the fused
    kernel packs each network once per call.

    ``grid`` (``accel.OccupancyGrid``) renders through empty-space
    skipping; with ``cfg.accel_cull_rays`` only the rays that can hit the
    occupied cells are rendered (:func:`_render_image_culled`).
    ``return_live`` (grid only) also returns the worst chunk's live sample
    counts, and ignores the packing."""
    cfg = cfg or RenderConfig()
    coarse, fine, key, grid, origin, dirs, chunk = _image_setup(
        params_coarse, params_fine, camera, height, width, key, cfg, device, grid)
    n = height * width
    with torch.no_grad():
        if grid is not None and cfg.accel_cull_rays and not return_live:
            out = _render_image_culled(coarse, fine, origin, dirs, camera.near, camera.far, key,
                                       cfg, grid, chunk)
            return out.reshape(height, width, 3)
        out = _render_flat(coarse, fine, origin, _pad_rays(dirs.reshape(n, 3), chunk),
                           camera.near, camera.far, key, cfg, chunk=chunk, grid=grid,
                           return_live=return_live)
    if return_live:
        rgb, live = out
        return rgb[:n].reshape(height, width, 3), live
    return out[:n].reshape(height, width, 3)


def render_image_aux(params_coarse, params_fine, camera: Camera, height: int, width: int,
                     key: torch.Tensor, cfg: Optional[RenderConfig] = None, *, device=None,
                     grid=None):
    """Full-frame render that also returns the depth map (expected t under
    the fine weights) and the accumulated opacity. Returns (rgb (H, W, 3),
    depth (H, W), acc (H, W)). The aux path runs the plain resampling
    chain (see :func:`render_rays`)."""
    cfg = cfg or RenderConfig()
    coarse, fine, key, grid, origin, dirs, chunk = _image_setup(
        params_coarse, params_fine, camera, height, width, key, cfg, device, grid)
    n = height * width
    dirs_flat = _pad_rays(dirs.reshape(n, 3), chunk)
    parts = []
    with torch.no_grad():
        for s in range(0, dirs_flat.shape[0], chunk):
            d = dirs_flat[s:s + chunk]
            ids = s + torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
            rgb, aux = render_rays(coarse, fine, origin, d, camera.near, camera.far, key, cfg,
                                   ray_ids=ids, grid=grid, return_aux=True)
            parts.append((rgb, aux["depth"], aux["acc"]))
    rgb, depth, acc = (torch.cat([p[i] for p in parts])[:n] for i in range(3))
    return rgb.reshape(height, width, 3), depth.reshape(height, width), acc.reshape(height, width)
