"""Ray sampling: stratified bins and hierarchical inverse-CDF resampling.

Numerical contracts from the reference renderer:
- stratified_samples: [near, far] split into ``count`` equal bins, one
  uniform jittered sample per bin.
- importance_samples: PDF from the *interior* coarse weights
  weights[1..n-1], bins are midpoints of the coarse t-values, weights
  clamped >= 0 plus 1e-5 then normalized, CDF's final entry forced to 1.0,
  bin lookup is "first j with cdf[j] <= u < cdf[j+1]", linear
  interpolation inside the bin with the denominator clamped to 1e-6. Fine
  samples are merged with the coarse ones and sorted by the caller.

Random draws come from :mod:`nerf_rs_tpu_torch.ops.random`, so the samples
equal the JAX package's for the same keys.
"""

from __future__ import annotations

import torch

from nerf_rs_tpu_torch.ops import random


def _batched_uniform(key: torch.Tensor, batch_shape, count: int) -> torch.Tensor:
    """(*batch_shape, count) float32 uniforms. ``key`` is one (2,) key (one
    stream for the whole batch) or (B, 2) per-ray keys, which make renders
    invariant to chunking."""
    return random.uniform(key, (*tuple(batch_shape), count))


def stratified_samples(key: torch.Tensor, near, far, count: int,
                       batch_shape: tuple = ()) -> torch.Tensor:
    """Jittered equal-bin samples of [near, far] -> (*batch_shape, count)."""
    u = _batched_uniform(key, batch_shape, count)
    interval = (far - near) / count
    lower = near + torch.arange(count, dtype=u.dtype, device=u.device) * interval
    return lower + interval * u


def importance_samples(key: torch.Tensor, ts: torch.Tensor, weights: torch.Tensor,
                       count: int, *, pdf_eps: float = 1e-5,
                       cdf_eps: float = 1e-6) -> torch.Tensor:
    """Inverse-CDF resampling of ``count`` new t's per ray.

    ts: (..., Nc) sorted sample positions; weights: (..., Nc) transmittance
    weights; Nc >= 3. Returns (..., count), NOT sorted.
    """
    u = _batched_uniform(key, ts.shape[:-1], count)
    return inverse_cdf(ts, weights, u, pdf_eps=pdf_eps, cdf_eps=cdf_eps)


def inverse_cdf(ts: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, *,
                pdf_eps: float = 1e-5, cdf_eps: float = 1e-6) -> torch.Tensor:
    """The body of :func:`importance_samples` for given uniforms ``u``
    (..., count): one new t per uniform, NOT sorted. The fused resampler's
    plain version (``ops.kernels.resample``) calls it with the uniforms its
    kernel reads."""
    n_c = ts.shape[-1]
    if n_c < 3:
        raise ValueError(f"importance sampling requires >= 3 coarse samples, got {n_c}")

    bins = 0.5 * (ts[..., 1:] + ts[..., :-1])                        # (..., Nc-1)
    pdf_w = torch.clamp(weights[..., 1:-1], min=0.0) + pdf_eps        # (..., Nc-2)
    pdf = pdf_w / torch.sum(pdf_w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1],
                     torch.ones_like(cdf[..., :1])], dim=-1)          # (..., Nc-1)

    # The CDF is strictly increasing (every PDF entry >= the pdf_eps
    # floor), so "first j with cdf[j] <= u < cdf[j+1]" is one bin, which a
    # right-sided search finds.
    j = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1
    j = torch.clamp(j, 0, n_c - 3)
    cdf_lo = torch.gather(cdf, -1, j)
    cdf_hi = torch.gather(cdf, -1, j + 1)
    bin_lo = torch.gather(bins, -1, j)
    bin_hi = torch.gather(bins, -1, j + 1)
    frac = (u - cdf_lo) / torch.clamp(cdf_hi - cdf_lo, min=cdf_eps)
    return bin_lo + (bin_hi - bin_lo) * frac


def merge_samples(t_coarse: torch.Tensor, t_fine: torch.Tensor) -> torch.Tensor:
    """Merge coarse + fine t's and sort ascending (fixed width Nc + Nf)."""
    return torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values
