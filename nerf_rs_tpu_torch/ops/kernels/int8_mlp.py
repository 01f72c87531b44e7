"""W8A8 NeRF MLP: the int8 CUDA kernel's wrapper, its weight packing and
its plain PyTorch version.

The kernel (``csrc/int8_mlp_tc.cu``) is the port's counterpart of the JAX
package's int8 probe P2 (``tools/pallas_int8_probe.py:66``): a chain of
int8 x int8 -> int32 products with the weights resident, each followed by
an f32 epilogue and a per-sample absmax requantize to int8. Here that chain
is the real W8A8 NeRF MLP, ``models.quant.int8_nerf_mlp(fake=False)``,
both the full and the ``sigma_only`` variant, in one launch per call, with
the products on s8 ``wgmma`` (Hopper's tensor cores).

- :func:`pack_int8_params` quantizes every layer once with
  ``models.quant.quantize_weights`` and tiles the codes for ``wgmma``
  (:func:`int8_tile`);
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

_PIECE = 64                 # kPiece: the kernel's wgmma N; widths pad to it
_HEAD_LD = 8                # the alpha and rgb heads' padded column count


def _unserved(params) -> str:
    width, v_width, depth, _ = infer_arch(params.tree() if hasattr(params, "tree") else params)
    return (f"int8 kernel serves width, v_width <= {MAX_WIDTH} and depth <= {MAX_DEPTH}; got "
            f"width={width}, v_width={v_width}, depth={depth}")


@dataclasses.dataclass(frozen=True)
class PackedInt8MLP:
    """A network's int8 codes in the kernel's layout.

    ``weights`` (flat int8) holds one (K, ld) code matrix per layer, tiled
    by :func:`int8_tile` into ``wgmma``'s K-major core-matrix order
    (``segments[name] = (byte offset, K, ld)``, K in code rows).
    ``epilogue`` (flat f32) holds each layer's per-column weight scales
    and biases, padded to ld, interleaved for the kernel's epilogue: the
    columns 2 i and 2 i + 1 of the layer at ``slots[name] = (offset, n)``
    as ``[sw, sw, b, b]`` at ``epilogue[2 offset + 4 i:]``, one 16-byte
    load; ``scales`` and ``biases`` are views of it, flat like the slots.
    Every padding code, scale and bias is zero. ``ldw`` and ``ldv`` are the trunk
    and view widths padded to 64, the kernel's N. ``layout`` is the int64
    table in the order ``csrc/int8_mlp_tc.cu`` reads it.
    """

    weights: torch.Tensor
    epilogue: torch.Tensor
    segments: Dict[str, Tuple[int, int, int]]
    slots: Dict[str, Tuple[int, int]]
    layout: np.ndarray
    width: int
    v_width: int
    depth: int
    ldw: int
    ldv: int

    @property
    def scales(self) -> torch.Tensor:
        return self.epilogue.view(-1, 4)[:, :2].reshape(-1)

    @property
    def biases(self) -> torch.Tensor:
        return self.epilogue.view(-1, 4)[:, 2:].reshape(-1)

    def codes(self, name: str) -> torch.Tensor:
        """Layer ``name``'s padded (K, ld) int8 codes, untiled."""
        off, k, ld = self.segments[name]
        tiles = self.weights[off:off + k * ld].view(k // 16, ld // 8, 8, 16)
        return tiles.permute(0, 3, 1, 2).reshape(k, ld)


def int8_tile(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 codes, K a multiple of 16 and N of 8 -> flat int8 in the
    order the kernel copies them into shared memory and s8 ``wgmma`` reads
    B: "K-major" 8 x 16 core matrices of 8 n-rows of 16 consecutive k (16
    bytes a row, 128 a matrix), the core matrix of k group kg and n group
    ng at byte ``(kg * N / 8 + ng) * 128``. Every 16 k-rows are one
    contiguous run of ``16 * N`` bytes, so any run of k-rows is one bulk
    copy."""
    k, n = codes.shape
    if k % 16 or n % 8:
        raise ValueError(f"cannot tile a {tuple(codes.shape)} code matrix")
    return codes.reshape(k // 16, 16, n // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def kernel_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's requantize (``csrc/int8_mlp_tc.cu::quant``) in torch
    ops: the quotient q = x * rs (rs = 1 / scale rounded to f32), corrected
    twice by its remainder, q = q + (x - scale q) rs with each of the two
    FMAs rounded once to f32 (emulated in float64, which holds the products
    exactly); then round half to even and clamp to [-127, 127]. Equals
    ``models.quant._codes(x, scale)`` wherever |x / scale| < 128, as it is
    for a row's own scale (where |x / scale| <= 127 / (1 - 2^-24), so the
    kernel leaves out the clamp)."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    rs = torch.reciprocal(scale)
    q = x * rs
    for _ in range(2):
        q = fma(fma(-scale, q, x), rs, q)
    return torch.clamp(torch.round(q), -127.0, 127.0)


def pack_int8_params(params) -> PackedInt8MLP:
    """Quantize and pack a param tree (tensors) for the kernel, on the
    params' device.

    Each layer's codes and per-column scales come from
    ``quantize_weights`` of its whole kernel, so the skip layer's scales
    span all 63 + width rows and the view layer's all width + 27. Rows pad
    to the kernel's input layout: the encode 63 -> 64 (placed first in the
    skip layer), widths to a multiple of 64, the dir encode 27 -> 32 after
    the bottleneck's rows; columns pad to a multiple of 64 (the heads' to
    8). Serves what ``fused_mlp.supports_arch`` serves; anything else
    raises ValueError.
    """
    if not supports_arch(params):
        raise ValueError(_unserved(params))
    width, v_width, depth, _ = infer_arch(params)
    ldw, ldv = _round_up(width, _PIECE), _round_up(v_width, _PIECE)
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

    codes_tc, epilogue = [], []
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
        codes_tc.append(int8_tile(padded))
        segments[name] = (off, k, ld)
        off += k * ld                   # k a multiple of 16, ld of 8: 128-byte aligned segments
        scales = torch.nn.functional.pad(sw[0], (0, ld - n_out))
        bias = torch.nn.functional.pad(params[name]["bias"].detach().to(torch.float32),
                                       (0, ld - n_out))
        epilogue.append(torch.cat([scales.view(-1, 2), bias.view(-1, 2)], 1).reshape(-1))
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
    return PackedInt8MLP(weights=torch.cat(codes_tc), epilogue=torch.cat(epilogue),
                         segments=segments, slots=slots, layout=layout,
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
        pk.epilogue.data_ptr(), pk.layout.ctypes.data, pk.layout.size,
        pk.ldw, pk.ldv, pk.depth, int(sigma_only), rgb.data_ptr(), sigma.data_ptr(),
        points.device.index or 0, _stream(points.device))
    if err != 0:
        raise RuntimeError(f"int8 MLP kernel launch failed with CUDA error {err}")
    fused_int8_mlp.launches += 1
    return rgb, sigma


fused_int8_mlp.launches = 0
