"""End-to-end hierarchical NeRF rendering.

One batched program over a [num_rays, num_samples] grid:

    coarse stratified samples -> coarse MLP (sigmas only)
    -> transmittance weights -> inverse-CDF importance resampling
    -> merge + sort (fixed width Nc + Nf) -> fine MLP
    -> transmittance-weighted compositing onto a white background.

Image renders loop over fixed-size ray chunks on the host. Each ray draws
from its own random stream, folded from the render key by its global ray
index, so an image does not depend on the chunk size, and equals the JAX
package's render of the same key (``ops.random`` matches ``jax.random``
bit for bit).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.models.mlp import as_module, nerf_mlp
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import Camera, camera_rays
from nerf_rs_tpu_torch.ops.sampling import importance_samples, merge_samples, stratified_samples
from nerf_rs_tpu_torch.ops.volume import composite, compute_weights


def get_mlp_fn(cfg: RenderConfig):
    """Resolve the field network: the plain PyTorch MLP (``impl="xla"``)
    or the fused CUDA kernel (``impl="pallas"``). Families and impls the
    port does not serve yet raise NotImplementedError."""
    if cfg.model == "hashgrid":
        raise NotImplementedError("model='hashgrid' is not ported yet (ROADMAP queue 1, item 12)")
    if cfg.model != "mlp":
        raise ValueError(f"unknown model {cfg.model!r} (expected 'mlp' or 'hashgrid')")
    if cfg.impl == "pallas":
        from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

        return functools.partial(fused_nerf_mlp, x_freqs=cfg.x_freqs, d_freqs=cfg.d_freqs,
                                 dtype=cfg.dtype)
    if cfg.impl in ("int8", "int8qat"):
        raise NotImplementedError(f"impl={cfg.impl!r} is not ported yet (ROADMAP queue 1, item 12)")
    if cfg.impl != "xla":
        raise ValueError(f"unknown MLP impl {cfg.impl!r} "
                         "(expected 'xla', 'pallas', 'int8', or 'int8qat')")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]

    def xla_mlp(params, points, viewdirs, sigma_only: bool = False):
        rgb, sigma = nerf_mlp(params, points.to(dt), viewdirs.to(dt), x_freqs=cfg.x_freqs,
                              d_freqs=cfg.d_freqs, sigma_only=sigma_only)
        return rgb.to(torch.float32), sigma.to(torch.float32)

    return xla_mlp


def _check_served(cfg: RenderConfig, grid) -> None:
    if grid is not None:
        raise NotImplementedError("occupancy-grid acceleration is not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    if cfg.sampling_impl == "pallas":
        raise NotImplementedError("sampling_impl='pallas' (fused resample kernel K3) is not "
                                  "ported yet (ROADMAP queue 1, item 13)")
    if cfg.sampling_impl != "xla":
        raise ValueError(f"unknown sampling_impl {cfg.sampling_impl!r}")


def render_rays(params_coarse, params_fine, origin: torch.Tensor, dirs: torch.Tensor,
                near, far, key: torch.Tensor, cfg: RenderConfig, *,
                ray_ids: Optional[torch.Tensor] = None, grid=None,
                return_aux: bool = False):
    """Render a batch of rays -> fine RGB (..., 3), differentiable in the
    networks' parameters.

    origin: (3,) shared camera origin (or (..., 3) per-ray origins); dirs:
    (..., 3) *unit* directions; near/far: scalars or 0-d tensors; key: a
    (2,) key from ``ops.random.key``. ``ray_ids`` (flat (B,) ints, dirs
    then (B, 3)) gives every ray its own random stream, folded in by its
    id, which makes renders invariant to chunking. With ``cfg.n_fine ==
    0`` the coarse field is composited directly (single pass).

    ``return_aux`` also returns the JAX package's aux dict (``rgb_coarse``,
    ``acc``, ``weights_coarse``, ``weights_fine``, ``t_coarse``,
    ``t_fine``, ``depth``); the coarse pass then runs the full network, as
    training needs the coarse image. The importance samples are detached,
    as in JAX.
    """
    _check_served(cfg, grid)
    mlp = get_mlp_fn(cfg)
    batch_shape = tuple(dirs.shape[:-1])
    k_coarse, k_fine = random.split(key)
    if ray_ids is not None:
        if dirs.dim() != 2:
            raise ValueError("ray_ids requires flat (B, 3) dirs")
        k_coarse = random.fold_in(k_coarse, ray_ids)
        k_fine = random.fold_in(k_fine, ray_ids)
    near = torch.as_tensor(near, dtype=torch.float32, device=dirs.device)
    far = torch.as_tensor(far, dtype=torch.float32, device=dirs.device)

    # --- coarse pass: the coarse colors are discarded unless single-pass
    # or the caller needs the coarse image ---
    t_c = stratified_samples(k_coarse, near, far, cfg.n_coarse, batch_shape)
    pts_c = origin[..., None, :] + dirs[..., None, :] * t_c[..., :, None]
    single_pass = cfg.n_fine == 0
    rgb_c, sigma_c = mlp(params_coarse, pts_c, dirs[..., None, :],
                         sigma_only=not (single_pass or return_aux))
    w_c = compute_weights(sigma_c, t_c, far, t_threshold=cfg.t_threshold)
    if single_pass:
        rgb = composite(rgb_c, w_c, white_background=cfg.white_background)
        if not return_aux:
            return rgb
        return rgb, {"rgb_coarse": rgb, "acc": torch.sum(w_c, dim=-1), "weights_coarse": w_c,
                     "weights_fine": w_c, "t_coarse": t_c, "t_fine": t_c,
                     "depth": torch.sum(w_c * t_c, dim=-1)}

    # --- hierarchical resampling ---
    t_extra = importance_samples(k_fine, t_c, w_c, cfg.n_fine, pdf_eps=cfg.pdf_eps,
                                 cdf_eps=cfg.cdf_eps)
    t_f = merge_samples(t_c, t_extra.detach())

    # --- fine pass ---
    pts_f = origin[..., None, :] + dirs[..., None, :] * t_f[..., :, None]
    rgb_f, sigma_f = mlp(params_fine, pts_f, dirs[..., None, :])
    w_f = compute_weights(sigma_f, t_f, far, t_threshold=cfg.t_threshold)
    rgb = composite(rgb_f, w_f, white_background=cfg.white_background)
    if not return_aux:
        return rgb
    return rgb, {"rgb_coarse": composite(rgb_c, w_c, white_background=cfg.white_background),
                 "acc": torch.sum(w_f, dim=-1), "weights_coarse": w_c, "weights_fine": w_f,
                 "t_coarse": t_c, "t_fine": t_f, "depth": torch.sum(w_f * t_f, dim=-1)}


def _render_flat(params_coarse, params_fine, origin, dirs_flat, near, far, key,
                 cfg: RenderConfig, ray_id_base: int = 0,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """Render (N, 3) unit dirs in chunks of ``chunk`` (default
    ``cfg.ray_chunk``) rays -> (N, 3). Ray ``i`` draws from the stream of
    global id ``ray_id_base + i`` whatever the chunking."""
    n = dirs_flat.shape[0]
    chunk = chunk or cfg.ray_chunk
    outs = []
    for s in range(0, n, chunk):
        d = dirs_flat[s:s + chunk]
        ids = ray_id_base + s + torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
        outs.append(render_rays(params_coarse, params_fine, origin, d, near, far, key, cfg,
                                ray_ids=ids))
    return torch.cat(outs, dim=0)


def render_image(params_coarse, params_fine, camera: Camera, height: int, width: int,
                 key: torch.Tensor, cfg: Optional[RenderConfig] = None, *, device=None,
                 grid=None) -> torch.Tensor:
    """Render a full (height, width, 3) f32 image on ``device`` (default:
    the key's device). The networks are param trees or NerfMLPs; both
    become NerfMLPs on the device, so the fused kernel packs each network
    once per call."""
    cfg = cfg or RenderConfig()
    _check_served(cfg, grid)
    device = torch.device(device) if device is not None else key.device
    key = key.to(device)
    coarse = as_module(params_coarse, device)
    fine = as_module(params_fine, device)
    origin, dirs = camera_rays(camera, height, width, device)
    with torch.no_grad():
        out = _render_flat(coarse, fine, origin[0, 0], dirs.reshape(-1, 3),
                           camera.near, camera.far, key, cfg)
    return out.reshape(height, width, 3)
