"""Int8 quantization for the MLP family: W8A8 inference and QAT fake-quant,
the port of ``nerf_rs_tpu/models/quant.py``.

Scheme (both modes share the same arithmetic, so QAT trains exactly the
numbers inference runs):

- Weights: symmetric per-OUTPUT-channel int8, scale = absmax / 127 per
  column (:func:`quantize_weights`). Biases stay f32.
- Activations: symmetric per-ROW (per-sample) dynamic int8, scale =
  absmax / 127 over the whole input row of each layer, concatenations
  included (the skip layer's ``[h0, h]``, the view layer's
  ``[bottleneck, dirs_enc]``).
- Accumulation: int32, dequantized as ``((acc * sx) * sw) + b``.

Two ``RenderConfig.impl`` values plug this into every render and train
path through ``render.get_mlp_fn``:

- ``impl="int8"``: real W8A8 inference, through the hand-written int8 MLP
  kernel on the card (``ops/kernels/int8_mlp.py``), whose plain version is
  :func:`int8_nerf_mlp` with ``fake=False``;
- ``impl="int8qat"``: the QAT training forward, :func:`int8_nerf_mlp` with
  ``fake=True``: the same quantized values in f32 with straight-through
  gradients to the f32 weights and activations.

Both ignore ``cfg.dtype``: the inputs are cast to f32.

Exactness. The codes' product is computed in f32 on copies of the codes:
every partial sum is an integer of magnitude at most 127 * 127 * 319 <
2^24, so any summation order gives the int32 accumulator exactly (torch
has no int8 product that accumulates in int32 on every device). Each
division is a true division by a tensor: on CUDA, torch divides by a
Python scalar as a product with its rounded reciprocal, which can differ
by an ulp from the division the kernel and the JAX package compute.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from nerf_rs_tpu_torch.models.encoding import positional_encoding

_QMAX = 127.0
_EPS = 1e-12


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward value q, identity gradient."""
    return x + (q - x).detach()


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    return torch.clamp_min(m / m.new_full((), _QMAX), _EPS)


def _weight_scale(w: torch.Tensor) -> torch.Tensor:
    """(1, out) symmetric per-output-channel scale."""
    return _absmax_scale(w, 0)


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """(..., 1) symmetric per-row (per-sample) dynamic scale."""
    return _absmax_scale(x, -1)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], in x's float dtype;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)


def quantize_weights(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An (in, out) kernel -> (int8 codes (in, out), f32 scales (1, out)).
    The int8 kernel's pack quantizes with this, so the kernel and its
    plain version read the same codes."""
    w = kernel.detach().to(torch.float32)
    sw = _weight_scale(w)
    return _codes(w, sw).to(torch.int8), sw


def _layer(params, name: str):
    p = params[name]
    return p["kernel"].to(torch.float32), p["bias"].to(torch.float32)


def _qdense_real(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Real W8A8 dense: int8 codes of x and the kernel, their exact
    product, then ``((acc * sx) * sw) + b``, three rounded ops."""
    w, b = _layer(params, name)
    wq, sw = quantize_weights(w)
    sx = _row_scale(x)
    acc = torch.matmul(_codes(x, sx), wq.to(torch.float32))
    return acc * sx * sw + b


def _qdense_fake(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """QAT dense: the same quantized values in f32, straight-through
    gradients to the weights and activations; the scales are constants."""
    w, b = _layer(params, name)
    sw = _weight_scale(w).detach()
    wf = _ste(w, _codes(w, sw) * sw)
    sx = _row_scale(x).detach()
    xf = _ste(x, _codes(x, sx) * sx)
    return torch.matmul(xf, wf) + b


def int8_nerf_mlp(
    params,
    points: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    x_freqs: int = 10,
    d_freqs: int = 4,
    sigma_only: bool = False,
    fake: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.mlp.nerf_mlp`` with every dense layer W8A8-quantized:
    ``fake=False`` is real int8 inference (the int8 kernel's plain
    version), ``fake=True`` the f32 STE emulation (the QAT forward).
    ``params`` is a param tree or a ``NerfMLP``; same contract and
    arch-inference rules as ``nerf_mlp``; f32 in and out."""
    params: Dict = params.tree() if hasattr(params, "tree") else params
    dense = _qdense_fake if fake else _qdense_real
    h0 = positional_encoding(points.to(torch.float32), x_freqs)
    h = h0
    n_dense = sum(1 for k in params if k.startswith("dense"))
    enc_dim = h0.shape[-1]
    for i in range(n_dense):
        d_in = params[f"dense{i}"]["kernel"].shape[0]
        if i > 0 and d_in == h.shape[-1] + enc_dim:
            h = torch.cat([h0, h], dim=-1)           # encoded input FIRST
        h = torch.relu(dense(params, f"dense{i}", h))

    sigma = torch.relu(dense(params, "alpha", h))[..., 0]
    if sigma_only:
        return torch.zeros((*sigma.shape, 3), dtype=sigma.dtype, device=sigma.device), sigma

    bottleneck = dense(params, "bottleneck", h)
    dirs_enc = positional_encoding(viewdirs.to(torch.float32), d_freqs)
    dirs_enc = torch.broadcast_to(dirs_enc, (*bottleneck.shape[:-1], dirs_enc.shape[-1]))
    q = torch.cat([bottleneck, dirs_enc], dim=-1)   # bottleneck FIRST
    hv = torch.relu(dense(params, "viewdirs", q))
    rgb = torch.sigmoid(dense(params, "rgb", hv))
    return rgb, sigma
