"""Volumetric integration: transmittance weights and alpha compositing.

    delta_i = t[i+1] - t[i]   (last: far - t[n-1]), clamped >= 0
    alpha_i = 1 - exp(-sigma_i * delta_i)
    w_i     = T_i * alpha_i;  T <- T * (1 - alpha_i)

The reference stops a ray's loop once T < 1e-4. With sigma >= 0 (ReLU
head) and delta >= 0, T never increases, so that early-out is exactly a
mask on the exclusive cumulative product.
"""

from __future__ import annotations

import torch


def sample_deltas(ts: torch.Tensor, far) -> torch.Tensor:
    """delta_i = t_{i+1} - t_i with final delta far - t_{n-1}, clamped >= 0."""
    last = far - ts[..., -1:]
    deltas = torch.cat([ts[..., 1:] - ts[..., :-1], last], dim=-1)
    return torch.clamp(deltas, min=0.0)


def _alpha_and_transmittance(sigmas: torch.Tensor, ts: torch.Tensor, far):
    alpha = 1.0 - torch.exp(-sigmas * sample_deltas(ts, far))
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    return alpha, torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)


def exclusive_transmittance(sigmas: torch.Tensor, ts: torch.Tensor, far) -> torch.Tensor:
    """T_k = prod_{j<k} (1 - alpha_j): the fraction of light reaching each sample."""
    return _alpha_and_transmittance(sigmas, ts, far)[1]


def compute_weights(sigmas: torch.Tensor, ts: torch.Tensor, far, *,
                    t_threshold: float = 1e-4) -> torch.Tensor:
    """Transmittance weights (..., S) for sigmas/ts of shape (..., S).
    ``t_threshold`` is the reference's early-out as a mask; 0.0 disables."""
    alpha, t_excl = _alpha_and_transmittance(sigmas, ts, far)
    weights = t_excl * alpha
    if t_threshold > 0.0:
        weights = torch.where(t_excl >= t_threshold, weights, torch.zeros_like(weights))
    return weights


def composite(colors: torch.Tensor, weights: torch.Tensor, *,
              white_background: bool = True) -> torch.Tensor:
    """rgb = sum_i w_i c_i, plus (1 - sum w) * white on a white background."""
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    if white_background:
        rgb = rgb + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return rgb


def integrate(colors: torch.Tensor, sigmas: torch.Tensor, ts: torch.Tensor, far, *,
              t_threshold: float = 1e-4, white_background: bool = True) -> torch.Tensor:
    """Weights and composite in one call: the reference's integrate_ray on
    tensors."""
    w = compute_weights(sigmas, ts, far, t_threshold=t_threshold)
    return composite(colors, w, white_background=white_background)
