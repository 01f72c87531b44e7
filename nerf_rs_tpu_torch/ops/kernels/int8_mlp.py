"""W8A8 NeRF MLP: the int8 CUDA kernel's wrapper, its weight packing and
its plain PyTorch version.

The kernel (``csrc/int8_mlp.cu``) is the port's counterpart of the JAX
package's int8 probe P2 (``tools/pallas_int8_probe.py:66``): a chain of
int8 x int8 -> int32 products with the weights resident, each followed by
an f32 epilogue and a per-sample absmax requantize to int8. Here that chain
is the real W8A8 NeRF MLP, ``models.quant.int8_nerf_mlp(fake=False)``,
both the full and the ``sigma_only`` variant, in one launch per call.

- :func:`pack_int8_params` quantizes every layer once with
  ``models.quant.quantize_weights`` and lays the codes out for the kernel;
  ``models.mlp.NerfMLP.packed("int8")`` keeps the pack until a parameter
  changes.
- :func:`fused_int8_mlp` launches the kernel on CUDA tensors (counted in
  ``fused_int8_mlp.launches``) and runs the plain version on CPU tensors.
  A CUDA tensor never reaches the plain version: an arch or encoding the
  kernel does not serve raises ``NotImplementedError``.
- :func:`fused_int8_mlp_reference` is the plain version,
  ``models.quant.int8_nerf_mlp(fake=False)``.

Inference only: the int8 values carry no gradient; QAT trains through
``int8_nerf_mlp(fake=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.models.quant import int8_nerf_mlp, quantize_weights
from nerf_rs_tpu_torch.ops.kernels import _build
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    _DF,
    _ENC_D,
    _ENC_D_RAW,
    _ENC_X,
    _ENC_X_RAW,
    _XF,
    MAX_DEPTH,
    MAX_WIDTH,
    _kernel_inputs,
    _round_up,
    _stream,
    infer_arch,
    supports_arch,
)

_HEAD_LD = 8                # kHeadLd: column stride of the alpha and rgb heads


def _unserved(params) -> str:
    width, v_width, depth, _ = infer_arch(params.tree() if hasattr(params, "tree") else params)
    return (f"int8 kernel serves width, v_width <= {MAX_WIDTH} and depth <= {MAX_DEPTH}; got "
            f"width={width}, v_width={v_width}, depth={depth}")


@dataclasses.dataclass(frozen=True)
class PackedInt8MLP:
    """A network's int8 codes in the kernel's layout.

    ``weights`` (flat int32) holds one K-major (K / 4, ld) word matrix per
    layer, word ``[k4, n]`` holding the codes of rows 4 k4 .. 4 k4 + 3 of
    column n in its bytes 0..3 (``segments[name] = (offset, K, ld)``, K in
    code rows). ``scales`` and ``biases`` (flat f32) hold each layer's
    per-column weight scales and biases at ``slots[name] = (offset, n)``.
    Every padding code, scale and bias is zero. ``layout`` is the int64
    table in the order ``csrc/int8_mlp.cu`` reads it.
    """

    weights: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    segments: Dict[str, Tuple[int, int, int]]
    slots: Dict[str, Tuple[int, int]]
    layout: np.ndarray
    width: int
    v_width: int
    depth: int
    ldw: int
    ldv: int

    def codes(self, name: str) -> torch.Tensor:
        """Layer ``name``'s padded (K, ld) int8 codes, unpacked."""
        off, k, ld = self.segments[name]
        words = self.weights[off:off + k // 4 * ld].view(k // 4, ld)
        return words.view(torch.int8).view(k // 4, ld, 4).permute(0, 2, 1).reshape(k, ld)


def _pack_words(codes: torch.Tensor) -> torch.Tensor:
    """(K, ld) int8 codes, K a multiple of 4 -> flat int32 words, word
    [k4, n] holding rows 4 k4 .. 4 k4 + 3 of column n in bytes 0..3."""
    k, ld = codes.shape
    return codes.reshape(k // 4, 4, ld).permute(0, 2, 1).contiguous().view(torch.int32).reshape(-1)


def pack_int8_params(params) -> PackedInt8MLP:
    """Quantize and pack a param tree (tensors) for the kernel, on the
    params' device.

    Each layer's codes and per-column scales come from
    ``quantize_weights`` of its whole kernel, so the skip layer's scales
    span all 63 + width rows and the view layer's all width + 27. Rows pad
    to the kernel's input layout: the encode 63 -> 64 (placed first in the
    skip layer), widths to a multiple of 8, the dir encode 27 -> 32 after
    the bottleneck's rows; columns pad to a multiple of 8. Serves what
    ``fused_mlp.supports_arch`` serves; anything else raises ValueError.
    """
    if not supports_arch(params):
        raise ValueError(_unserved(params))
    width, v_width, depth, _ = infer_arch(params)
    ldw, ldv = _round_up(width, 8), _round_up(v_width, 8)
    device = params["dense0"]["kernel"].device

    def check(name, shape):
        got = tuple(params[name]["kernel"].shape)
        if got != shape:
            raise ValueError(f"{name}.kernel is {got}, expected {shape}")

    # (name, [(first code row in the padded input, real rows)], K, ld)
    layers = []
    check("dense0", (_ENC_X_RAW, width))
    layers.append(("dense0", [(0, _ENC_X_RAW)], _ENC_X, ldw))
    skips = []
    for i in range(1, depth):
        if tuple(params[f"dense{i}"]["kernel"].shape) == (width + _ENC_X_RAW, width):
            layers.append((f"dense{i}", [(0, _ENC_X_RAW), (_ENC_X, width)], _ENC_X + ldw, ldw))
            skips.append(i)
        else:
            check(f"dense{i}", (width, width))
            layers.append((f"dense{i}", [(0, width)], ldw, ldw))
    check("alpha", (width, 1))
    check("bottleneck", (width, width))
    check("viewdirs", (width + _ENC_D_RAW, v_width))
    check("rgb", (v_width, 3))
    layers += [("alpha", [(0, width)], ldw, _HEAD_LD),
               ("bottleneck", [(0, width)], ldw, ldw),
               ("viewdirs", [(0, width), (ldw, _ENC_D_RAW)], ldw + _ENC_D, ldv),
               ("rgb", [(0, v_width)], ldv, _HEAD_LD)]

    words, scales, biases = [], [], []
    segments: Dict[str, Tuple[int, int, int]] = {}
    slots: Dict[str, Tuple[int, int]] = {}
    off = soff = 0
    for name, pieces, k, ld in layers:
        codes, sw = quantize_weights(params[name]["kernel"])
        n_out = codes.shape[1]
        padded = torch.zeros((k, ld), dtype=torch.int8, device=device)
        src = 0
        for row, rows in pieces:
            padded[row:row + rows, :n_out] = codes[src:src + rows]
            src += rows
        words.append(_pack_words(padded))
        segments[name] = (off, k, ld)
        off += k // 4 * ld              # ld is a multiple of 8: 32-byte aligned segments
        scales.append(torch.nn.functional.pad(sw[0], (0, ld - n_out)))
        bias = params[name]["bias"].detach().to(torch.float32)
        biases.append(torch.nn.functional.pad(bias, (0, ld - n_out)))
        slots[name] = (soff, n_out)
        soff += ld

    def seg(name):
        return segments[name][0]

    def slot(name):
        return slots[name][0]

    layout = np.array(
        [seg(f"dense{i}") if i < depth else -1 for i in range(MAX_DEPTH)]
        + [slot(f"dense{i}") if i < depth else -1 for i in range(MAX_DEPTH)]
        + [int(i in skips) for i in range(MAX_DEPTH)]
        + [seg(n) for n in ("alpha", "bottleneck", "viewdirs", "rgb")]
        + [slot(n) for n in ("alpha", "bottleneck", "viewdirs", "rgb")],
        dtype=np.int64)
    return PackedInt8MLP(weights=torch.cat(words), scales=torch.cat(scales),
                         biases=torch.cat(biases), segments=segments, slots=slots, layout=layout,
                         width=width, v_width=v_width, depth=depth, ldw=ldw, ldv=ldv)


def fused_int8_mlp_reference(params, points: torch.Tensor, viewdirs: torch.Tensor, *,
                             x_freqs: int = 10, d_freqs: int = 4,
                             sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version, on any device:
    ``models.quant.int8_nerf_mlp(fake=False)``, which quantizes the
    weights with the same ``quantize_weights`` as the pack."""
    return int8_nerf_mlp(params, points, viewdirs, x_freqs=x_freqs, d_freqs=d_freqs,
                         sigma_only=sigma_only, fake=False)


def fused_int8_mlp(params, points: torch.Tensor, viewdirs: torch.Tensor, *, x_freqs: int = 10,
                   d_freqs: int = 4, sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """W8A8 drop-in for ``models.mlp.nerf_mlp``: ``params`` is a NerfMLP
    (whose int8 pack is reused) or a param tree (packed on every call);
    points (..., 3), viewdirs (..., 3) broadcastable against them, cast to
    f32 -> (rgb (..., 3), sigma (...,)) f32. With ``sigma_only`` rgb is
    zeros.

    CUDA tensors launch the kernel on the current stream without
    synchronizing, one launch per call; CPU tensors run
    :func:`fused_int8_mlp_reference`. On the card an arch beyond
    ``supports_arch`` or other encodings than (10, 4) raise
    NotImplementedError.
    """
    if points.device.type == "cpu":
        return fused_int8_mlp_reference(params, points, viewdirs, x_freqs=x_freqs,
                                        d_freqs=d_freqs, sigma_only=sigma_only)
    if points.device.type != "cuda":
        raise ValueError(f"fused_int8_mlp takes CPU or CUDA tensors, got {points.device}")
    if (x_freqs, d_freqs) != (_XF, _DF):
        raise NotImplementedError(f"int8 kernel is specialized to L=({_XF},{_DF}) encodings, "
                                  f"got ({x_freqs},{d_freqs})")
    if not supports_arch(params):
        raise NotImplementedError(_unserved(params))
    pk = params.packed("int8") if hasattr(params, "packed") else pack_int8_params(params)
    points = points.to(torch.float32).contiguous()
    viewdirs = viewdirs.to(torch.float32)
    dirs, dir_div, batch, n = _kernel_inputs(pk, points, viewdirs)
    rgb = torch.empty((*batch, 3), dtype=torch.float32, device=points.device)
    sigma = torch.empty(batch, dtype=torch.float32, device=points.device)
    if n == 0:
        return rgb, sigma
    err = _build.load_library().nerf_int8_mlp_forward(
        points.data_ptr(), dirs.data_ptr(), n, dir_div, pk.weights.data_ptr(),
        pk.scales.data_ptr(), pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size,
        pk.ldw, pk.ldv, pk.depth, int(sigma_only), rgb.data_ptr(), sigma.data_ptr(),
        points.device.index or 0, _stream(points.device))
    if err != 0:
        raise RuntimeError(f"int8 MLP kernel launch failed with CUDA error {err}")
    fused_int8_mlp.launches += 1
    return rgb, sigma


fused_int8_mlp.launches = 0
