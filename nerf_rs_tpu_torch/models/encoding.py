"""Sinusoidal positional encoding.

The reference scheme: the identity triple first, then per frequency band a
sin-triple followed by a cos-triple; frequencies start at 1.0 and double per
band, with **no pi factor**. Output feature count is ``3 + 6 * num_freqs``
(63 for points at L=10, 27 for view dirs at L=4).
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """gamma(x) for (..., 3) inputs -> (..., 3 + 6*num_freqs), in x's dtype.

    Feature order: [x, y, z, sin(1*x), sin(1*y), sin(1*z), cos(1*x),
    cos(1*y), cos(1*z), sin(2*x), ..., cos(2^{L-1}*z)].
    """
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]                    # (..., L, 3)
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)  # (..., L, 2, 3)
    enc = enc.reshape(*x.shape[:-1], num_freqs * 6)
    return torch.cat([x, enc], dim=-1)
