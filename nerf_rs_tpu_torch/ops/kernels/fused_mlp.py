"""Fused NeRF MLP forward: the CUDA kernel's wrapper, its weight packing and
its plain PyTorch version.

The kernel (``csrc/fused_mlp.cu``) replaces the JAX package's Pallas
kernel ``nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t`` /
``_mlp_chain``: per tile of samples it encodes points and dirs, runs the
trunk with the skip layer as two summed products, the ReLU sigma head and,
unless ``sigma_only``, the bottleneck, the view layer (two summed
products) and the sigmoid rgb head, with activations kept on chip.

- :func:`pack_params` lays the weights out for the kernel, once per
  network and dtype (``models.mlp.NerfMLP.packed`` keeps the pack).
- :func:`fused_nerf_mlp` launches the kernel on CUDA tensors and counts
  launches in ``fused_nerf_mlp.launches``. On CPU tensors it runs the
  plain version instead; it never falls back on a CUDA tensor.
- :func:`fused_nerf_mlp_reference` is the plain version: the same
  function from the same packed weights, with the kernel's casting.

Numerics: ``float32`` is true f32 throughout, with exact sin/cos.
``bfloat16`` rounds the encode, the weights and each layer's input
activations to bf16 and accumulates in f32; the heads read the rounded
activations and return f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.ops.kernels import _build

_XF, _DF = 10, 4            # encoding bands the kernel serves (points, dirs)
_ENC_X_RAW, _ENC_D_RAW = 3 + 6 * _XF, 3 + 6 * _DF   # 63, 27
_ENC_X, _ENC_D = 64, 32     # the kernel's padded encode rows
MAX_DEPTH = 16              # kMaxDepth in csrc/fused_mlp.cu
MAX_WIDTH = 256             # kMaxWidth: widest trunk or view branch served
_ALIGN = 8                  # segment offsets: 16-byte aligned bf16 loads
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def infer_arch(params) -> Tuple[int, int, int, int]:
    """(width, v_width, depth, skip_at) of a param tree; skip_at is the
    index of the layer BEFORE the one that takes the encoded input again
    (depth - 1 when no layer does)."""
    depth = sum(1 for k in params if k.startswith("dense"))
    width = int(params["dense0"]["kernel"].shape[1])
    v_width = int(params["viewdirs"]["kernel"].shape[1])
    skip_at = depth - 1
    for i in range(1, depth):
        if int(params[f"dense{i}"]["kernel"].shape[0]) > width:
            skip_at = i - 1
            break
    return width, v_width, depth, skip_at


@dataclasses.dataclass(frozen=True)
class PackedMLP:
    """Weights in the kernel's layout.

    ``weights`` (flat, compute dtype) holds one K-major (K, ld) matrix per
    segment, ``segments[name] = (offset, K, ld)``; ``biases`` (flat f32)
    holds ``bias_slots[name] = (offset, n)``. Segment names: ``dense{i}``
    (layer i's trunk input, or the encode for i = 0), ``dense{i}_enc``
    (the encode input of a skip layer), ``alpha``, ``bottleneck``,
    ``viewdirs``, ``viewdirs_dir`` (the dir-encode input of the view
    layer) and ``rgb``. Every padding entry is zero. ``layout`` is the
    int64 offset table in the order ``csrc/fused_mlp.cu`` reads it.
    """

    weights: torch.Tensor
    biases: torch.Tensor
    segments: Dict[str, Tuple[int, int, int]]
    bias_slots: Dict[str, Tuple[int, int]]
    layout: np.ndarray
    width: int
    v_width: int
    depth: int
    ldw: int
    ldv: int
    dtype: str

    def mat(self, name: str) -> torch.Tensor:
        """Segment ``name`` as a float32 (K, ld) matrix."""
        off, k, ld = self.segments[name]
        return self.weights[off:off + k * ld].view(k, ld).to(torch.float32)

    def bias(self, name: str) -> torch.Tensor:
        off, n = self.bias_slots[name]
        return self.biases[off:off + n]


def pack_params(params, dtype: str) -> PackedMLP:
    """Pack a param tree (tensors) for the kernel, on the params' device.

    Each layer is transposed to K-major (in, out) segments with zero
    padding: the encode input pads 63 -> 64 rows and the dir encode
    27 -> 32, widths pad to a multiple of 8. The skip layer and the view
    layer are split into their two inputs. Serves every arch whose trunk
    and view widths are at most ``MAX_WIDTH`` with at most ``MAX_DEPTH``
    dense layers; any other raises ValueError.
    """
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
    width, v_width, depth, _ = infer_arch(params)
    if not (1 <= width <= MAX_WIDTH and 1 <= v_width <= MAX_WIDTH and 1 <= depth <= MAX_DEPTH):
        raise ValueError(
            f"fused kernel serves width, v_width <= {MAX_WIDTH} and depth <= "
            f"{MAX_DEPTH}; got width={width}, v_width={v_width}, depth={depth}")
    ldw, ldv = _round_up(width, 8), _round_up(v_width, 8)
    device = params["dense0"]["kernel"].device

    def kern(name):
        return params[name]["kernel"].detach().to(torch.float32)

    mats = []  # (name, matrix, rows, ld)

    def check_in(name, got, want):
        if got != want:
            raise ValueError(f"{name}.kernel input dim {got} != {want}")

    check_in("dense0", kern("dense0").shape[0], _ENC_X_RAW)
    mats.append(("dense0", kern("dense0"), _ENC_X, ldw))
    for i in range(1, depth):
        k = kern(f"dense{i}")
        if k.shape[1] != width:
            raise ValueError(f"dense{i}.kernel output dim {k.shape[1]} != width {width}")
        if k.shape[0] == width + _ENC_X_RAW:      # skip: encoded input rows FIRST
            mats.append((f"dense{i}_enc", k[:_ENC_X_RAW], _ENC_X, ldw))
            k = k[_ENC_X_RAW:]
        check_in(f"dense{i}", k.shape[0], width)
        mats.append((f"dense{i}", k, ldw, ldw))
    check_in("alpha", kern("alpha").shape[0], width)
    check_in("bottleneck", kern("bottleneck").shape[0], width)
    view = kern("viewdirs")
    check_in("viewdirs", view.shape[0], width + _ENC_D_RAW)
    if tuple(kern("rgb").shape) != (v_width, 3) or kern("alpha").shape[1] != 1:
        raise ValueError("heads must be alpha (width, 1) and rgb (v_width, 3)")
    mats += [("alpha", kern("alpha"), ldw, 1),
             ("bottleneck", kern("bottleneck"), ldw, ldw),
             ("viewdirs", view[:width], ldw, ldv),
             ("viewdirs_dir", view[width:], _ENC_D, ldv),
             ("rgb", kern("rgb"), ldv, 3)]

    segments: Dict[str, Tuple[int, int, int]] = {}
    pieces = []
    off = 0
    for name, m, rows, ld in mats:
        padded = torch.zeros((rows, ld), dtype=torch.float32, device=device)
        padded[:m.shape[0], :m.shape[1]] = m
        size = _round_up(rows * ld, _ALIGN)
        pieces.append(torch.nn.functional.pad(padded.reshape(-1), (0, size - rows * ld)))
        segments[name] = (off, rows, ld)
        off += size
    weights = torch.cat(pieces).to(_DTYPES[dtype])

    bias_slots: Dict[str, Tuple[int, int]] = {}
    bpieces = []
    boff = 0
    for name, n in ([(f"dense{i}", ldw) for i in range(depth)]
                    + [("alpha", 1), ("bottleneck", ldw), ("viewdirs", ldv), ("rgb", 3)]):
        b = params[name]["bias"].detach().to(torch.float32)
        size = _round_up(n, _ALIGN)
        bpieces.append(torch.nn.functional.pad(b, (0, size - b.shape[0])))
        bias_slots[name] = (boff, n)
        boff += size
    biases = torch.cat(bpieces)

    def seg(name):
        return segments[name][0] if name in segments else -1

    layout = np.array(
        [seg(f"dense{i}") if i < depth else -1 for i in range(MAX_DEPTH)]
        + [seg(f"dense{i}_enc") for i in range(MAX_DEPTH)]
        + [seg(n) for n in ("alpha", "bottleneck", "viewdirs", "viewdirs_dir", "rgb")]
        + [bias_slots[f"dense{i}"][0] if i < depth else -1 for i in range(MAX_DEPTH)]
        + [bias_slots[n][0] for n in ("alpha", "bottleneck", "viewdirs", "rgb")],
        dtype=np.int64)
    return PackedMLP(weights=weights, biases=biases, segments=segments,
                     bias_slots=bias_slots, layout=layout, width=width, v_width=v_width,
                     depth=depth, ldw=ldw, ldv=ldv, dtype=dtype)


def _packed(params, dtype: str) -> PackedMLP:
    """The pack of a NerfMLP (kept by the module) or of a param tree."""
    if hasattr(params, "packed"):
        return params.packed(dtype)
    return pack_params(params, dtype)


def _check_call(x_freqs: int, d_freqs: int, dtype: str) -> None:
    if (x_freqs, d_freqs) != (_XF, _DF):
        raise NotImplementedError(
            f"fused kernel is specialized to L=({_XF},{_DF}) encodings, "
            f"got ({x_freqs},{d_freqs}) — use impl='xla'")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")


def _encode(x: torch.Tensor, freqs: int, rows: int) -> torch.Tensor:
    enc = positional_encoding(x, freqs)
    return torch.nn.functional.pad(enc, (0, rows - enc.shape[-1]))


def fused_nerf_mlp_reference(params, points: torch.Tensor, viewdirs: torch.Tensor, *,
                             x_freqs: int = 10, d_freqs: int = 4, dtype: str = "float32",
                             sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: same function, same packed
    weights, same bf16 rounding points; only the f32 summation order
    differs. Differentiable; any device."""
    _check_call(x_freqs, d_freqs, dtype)
    pk = _packed(params, dtype)
    if dtype == "bfloat16":
        def rnd(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        def rnd(x):
            return x
    batch = points.shape[:-1]
    pts = points.reshape(-1, 3).to(torch.float32)
    dirs = torch.broadcast_to(viewdirs, points.shape).reshape(-1, 3).to(torch.float32)
    enc_x = rnd(_encode(pts, x_freqs, _ENC_X))
    h = rnd(torch.relu(enc_x @ pk.mat("dense0") + pk.bias("dense0")))
    for i in range(1, pk.depth):
        acc = h @ pk.mat(f"dense{i}")
        if f"dense{i}_enc" in pk.segments:
            acc = acc + enc_x @ pk.mat(f"dense{i}_enc")
        h = rnd(torch.relu(acc + pk.bias(f"dense{i}")))
    sigma = torch.relu(h @ pk.mat("alpha") + pk.bias("alpha"))[:, 0]
    if sigma_only:
        rgb = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=pts.device)
    else:
        enc_d = rnd(_encode(dirs, d_freqs, _ENC_D))
        bneck = rnd(h @ pk.mat("bottleneck") + pk.bias("bottleneck"))
        hv = rnd(torch.relu(bneck @ pk.mat("viewdirs") + enc_d @ pk.mat("viewdirs_dir")
                            + pk.bias("viewdirs")))
        rgb = torch.sigmoid(hv @ pk.mat("rgb") + pk.bias("rgb"))
    return rgb.reshape(*batch, 3), sigma.reshape(batch)


def _requires_grad(params, *tensors) -> bool:
    tree = params.tree() if hasattr(params, "tree") else params
    leaves = [t for layer in tree.values() for t in layer.values()]
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in (*tensors, *leaves))


def fused_nerf_mlp(params, points: torch.Tensor, viewdirs: torch.Tensor, *,
                   x_freqs: int = 10, d_freqs: int = 4, dtype: str = "float32",
                   sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in fused replacement for ``models.mlp.nerf_mlp``.

    ``params`` is a NerfMLP (whose pack is reused) or a param tree (packed
    on every call). points (..., 3) f32, viewdirs (..., 3) f32 broadcastable
    against them -> (rgb (..., 3), sigma (...,)) f32. With ``sigma_only``
    rgb is zeros and the color branch is skipped.

    CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run :func:`fused_nerf_mlp_reference`.
    Forward only: with autograd recording and an input or a parameter that
    requires grad, a CUDA call raises NotImplementedError (the backward
    kernel is ROADMAP queue 1, item 9).
    """
    if points.device.type == "cpu":
        return fused_nerf_mlp_reference(params, points, viewdirs, x_freqs=x_freqs,
                                        d_freqs=d_freqs, dtype=dtype, sigma_only=sigma_only)
    if points.device.type != "cuda":
        raise ValueError(f"fused_nerf_mlp takes CPU or CUDA tensors, got {points.device}")
    _check_call(x_freqs, d_freqs, dtype)
    if torch.is_grad_enabled() and _requires_grad(params, points, viewdirs):
        raise NotImplementedError("the fused MLP kernel is forward-only; its backward "
                                  "(kernel K2) is ROADMAP queue 1, item 9")
    if points.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise TypeError(f"points and viewdirs must be float32, got {points.dtype} "
                        f"and {viewdirs.dtype}")
    if viewdirs.device != points.device:
        raise ValueError(f"viewdirs on {viewdirs.device}, points on {points.device}")
    if points.shape[-1] != 3 or viewdirs.shape[-1] != 3:
        raise ValueError(f"points {tuple(points.shape)} and viewdirs "
                         f"{tuple(viewdirs.shape)} must end in 3")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    pk = _packed(params, dtype)
    if pk.weights.device != points.device:
        raise ValueError(f"packed weights on {pk.weights.device}, points on {points.device}")
    batch = points.shape[:-1]
    n = points.numel() // 3
    if viewdirs.shape == points.shape:
        dirs, dir_div = viewdirs, 1
    elif points.dim() >= 2 and viewdirs.shape == (*points.shape[:-2], 1, 3):
        dirs, dir_div = viewdirs, points.shape[-2]      # one dir per ray
    else:
        dirs, dir_div = torch.broadcast_to(viewdirs, points.shape).contiguous(), 1
    if not dirs.is_contiguous():
        raise ValueError("viewdirs must be contiguous")
    with torch.no_grad():
        rgb = torch.empty((*batch, 3), dtype=torch.float32, device=points.device)
        sigma = torch.empty(batch, dtype=torch.float32, device=points.device)
        if n == 0:
            return rgb, sigma
        err = _build.load_library().nerf_fused_mlp_forward(
            points.data_ptr(), dirs.data_ptr(), n, dir_div, pk.weights.data_ptr(),
            pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size, pk.ldw, pk.ldv,
            pk.depth, int(dtype == "bfloat16"), int(sigma_only), rgb.data_ptr(),
            sigma.data_ptr(), points.device.index or 0,
            torch.cuda.current_stream(points.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused MLP kernel launch failed with CUDA error {err}")
        fused_nerf_mlp.launches += 1
    return rgb, sigma


fused_nerf_mlp.launches = 0
