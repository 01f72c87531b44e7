"""Fused NeRF MLP: the CUDA kernels' wrappers, their weight packing, their
plain PyTorch versions, and the autograd function that joins them.

The forward kernel K1 replaces the JAX package's Pallas kernel
``nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t`` / ``_mlp_chain``: per
tile of samples it encodes points and dirs, runs the trunk with the skip
layer as two summed products, the ReLU sigma head and, unless
``sigma_only``, the bottleneck, the view layer (two summed products) and
the sigmoid rgb head, with activations kept on chip. Up to width and
v_width 256 and depth 16 it has two kernels, both on the tensor cores with
weights bulk-copied into shared memory: float32
(``csrc/fused_mlp_f32tc.cu``: split-f32, every product six bf16 ``wgmma``
passes, :func:`split_f32_dense`) and bfloat16 (``csrc/fused_mlp_tc.cu``).
Wider or deeper networks, beyond ``NARROW_MAX_WIDTH`` or
``NARROW_MAX_DEPTH`` and up to ``MAX_WIDTH`` and ``MAX_DEPTH``, take the
wide pair: bfloat16 on ``wgmma`` in clusters of two CTAs that share the
weight stream (``csrc/fused_mlp_wide_tc.cu``) and float32 on the CUDA
cores (``csrc/fused_mlp_wide_f32.cu``), with offset
tables of ``MAX_DEPTH`` layers (``csrc/fused_mlp_wide.cuh``). The backward
kernel K2 replaces
``_backward_t`` / ``_kernel_bwd``: it recomputes the forward per tile,
backpropagates, and sums every layer's weight and bias gradient over the
samples. Each mode recomputes with its K1's own device code on its K1's
pack: float32 runs K1 f32's kernel in record mode over a round of tiles
(every layer's output into a workspace), then ``csrc/fused_mlp_bwd_tc.cu``
(dW and W·dz as 3xTF32 ``mma.sync``) over the same tiles; bfloat16 is one
kernel, ``csrc/fused_mlp_bwd_bf16.cu`` (every product a ``wgmma``). K2
serves K1's envelope: a wide pack runs the wide K2 in rounds of tiles
(:func:`wide_plan`): per round a per-tile kernel, float32
``csrc/fused_mlp_wide_bwd_tc.cu`` after the wide f32 forward's record
mode, bfloat16 ``csrc/fused_mlp_wide_bwd_bf16.cu`` (the recompute the wide
bf16 forward's device code, ``csrc/fused_mlp_wide_tc.cuh``), writes every
layer's input and output gradient to a workspace, and the dW kernel
``csrc/fused_mlp_wide_dw.cu`` sums the weight gradients over the round
(:func:`wide_dw_jobs`).

- :func:`pack_params` lays the weights out for the kernels, once per
  network and dtype (``models.mlp.NerfMLP.packed`` keeps the pack).
- :func:`fused_nerf_mlp` is differentiable on every device, through
  :class:`_FusedMLP` (the counterpart of ``_make_op``'s ``custom_vjp``).
  On CUDA tensors its forward launches K1 (counted in
  ``fused_nerf_mlp.launches``, in ``fused_nerf_mlp.tc_launches`` when the
  kernel runs on the tensor cores, which all but the wide f32 kernel do,
  and in ``fused_nerf_mlp.wide_launches`` for the wide pair) and its
  backward K2 (counted in ``fused_nerf_mlp_backward.launches``, and in
  ``fused_nerf_mlp_backward.wide_launches`` for the wide K2, whose dW
  kernel's launches, one a round, ``fused_nerf_mlp_backward.dw_launches``
  counts); on CPU
  tensors they run the plain versions instead. A CUDA tensor never
  reaches a plain version.
- :func:`fused_nerf_mlp_reference` and
  :func:`fused_nerf_mlp_backward_reference` are the plain versions: the
  same functions from the same packed weights, with the kernels' casting.
- :func:`unpack_grads` maps the packed gradient layout to the param tree.

Numerics: ``float32`` is f32 throughout, with exact sin/cos; the kernels'
layer products are split-f32 (within about 2^-22 of f32 products), their
plain versions' cuBLAS f32. ``bfloat16`` rounds the encode, the weights
and each layer's input activations to bf16 and accumulates in f32; the
heads read the rounded activations and return f32. The bf16 backward also
rounds each layer's output gradient to bf16 (after the ReLU mask) and
accumulates weight, bias and encode gradients in f32, as the JAX kernel
does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.ops.kernels import _build

_XF, _DF = 10, 4            # encoding bands the kernel serves (points, dirs)
_ENC_X_RAW, _ENC_D_RAW = 3 + 6 * _XF, 3 + 6 * _DF   # 63, 27
_ENC_X, _ENC_D = 64, 32     # the kernel's padded encode rows
# K1's and K2's envelope (kWideMaxDepth, kWideMaxWidth in
# csrc/fused_mlp_wide.cuh): the deepest trunk and the widest trunk or view
# branch the forward and the backward serve.
MAX_DEPTH = 32
MAX_WIDTH = 512
# The narrow kernels' envelope (kMaxDepth, kMaxWidth in
# csrc/fused_mlp_common.cuh): beyond it K1 and K2 run their wide kernels.
NARROW_MAX_DEPTH = 16
NARROW_MAX_WIDTH = 256
_ALIGN = 8                  # segment offsets: 16-byte aligned bf16 loads
_TC_PIECE = 64              # kPiece in csrc/fused_mlp_tc.cuh: tensor-core widths pad to it
_STEP_K = 16                # kStepK in csrc/fused_mlp_f32tc.cuh: k rows a split-f32 chunk
# The split-f32 product's six (x piece, w piece) pairs of a k-step, in the
# order csrc/fused_mlp_f32tc.cuh issues them (0 hi, 1 mid, 2 lo); the last,
# hi.hi, into its own accumulator.
SPLIT_F32_ORDER = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
_BWD_TILE = 128             # kRows in csrc/fused_mlp_bwd_{tc,bf16}.cu: samples a backward tile
_WIDE_BWD_TILE = 64         # kBlock of the wide backward kernels (csrc/fused_mlp_wide_bwd_*.cu)
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


def supports_dims(width: int, v_width: int, depth: int) -> bool:
    """Whether the forward kernel K1 serves these dimensions: trunk and view
    widths up to ``MAX_WIDTH``, at most ``MAX_DEPTH`` dense layers."""
    return 1 <= width <= MAX_WIDTH and 1 <= v_width <= MAX_WIDTH and 1 <= depth <= MAX_DEPTH


def narrow_dims(width: int, v_width: int, depth: int) -> bool:
    """Whether the narrow kernels (K1's and K2's) serve these dimensions:
    widths up to ``NARROW_MAX_WIDTH``, at most ``NARROW_MAX_DEPTH`` dense
    layers. Beyond them the wide kernels run."""
    return (1 <= width <= NARROW_MAX_WIDTH and 1 <= v_width <= NARROW_MAX_WIDTH
            and 1 <= depth <= NARROW_MAX_DEPTH)


def _dims(params) -> Tuple[int, int, int]:
    return infer_arch(params.tree() if hasattr(params, "tree") else params)[:3]


def supports_arch(params) -> bool:
    """Whether K1 serves a network (a NerfMLP or a param tree)."""
    return supports_dims(*_dims(params))


# K2 serves what K1 serves: whether ``impl="pallas"`` can train a network.
supports_backward_dims = supports_dims
supports_backward_arch = supports_arch


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
    int64 offset table in the order ``csrc/fused_mlp_common.cuh`` reads it,
    with ``NARROW_MAX_DEPTH`` layer slots; a ``wide`` pack (beyond the
    narrow kernels' envelope) has ``MAX_DEPTH`` slots in each of its
    tables, in the same order (``csrc/fused_mlp_wide.cuh``).

    f32 packs hold ``mma_wt``, the f32 backward kernels' tensor-core pack
    (``csrc/fused_mlp_bwd_tc.cuh``): the transpose of every segment but the
    two heads (for the input-gradient products), tiled by :func:`mma_tile`
    into ``mma.sync`` B-fragment order, at the offsets of ``layout_mma``
    (2 x the layer slots + 3 entries, 35 or 67, in the order dense{i},
    dense{i}_enc, bottleneck, viewdirs, viewdirs_dir). A transpose's K is
    the segment's ``ld`` padded to 16, its N the segment's rows. It holds two rows, ``hi = tf32_rna(w)`` and
    ``lo = tf32_rna(w - hi)`` (:func:`tf32_split`), for the kernel's 3xTF32
    products.

    f32 packs also hold ``weights_f32tc``, the split pack that the f32
    forward (``csrc/fused_mlp_f32tc.cu``) and the f32 backward's recompute
    read: every layer segment (not the heads, which the kernels read from
    ``weights``) tiled by :func:`f32tc_tile` as bf16 hi, mid and lo planes,
    widths and the K of the layers that read the trunk padded to multiples
    of 64, with ``layout_f32tc``, an offset table in ``layout``'s order
    (its head entries -1, its bias entries ``layout``'s).

    bf16 packs hold ``weights_tc`` instead, the tensor-core pack that the
    bf16 forward (``csrc/fused_mlp_tc.cu``) and the bf16 backward
    (``csrc/fused_mlp_bwd_bf16.cu``, which reads each layer chunk also
    transposed) share, with ``layout_tc``, an offset table in ``layout``'s
    order (the same bias offsets). Its layer segments are tiled by
    :func:`tc_tile`: trunk and view widths pad to multiples of 64, and so
    does the K of the layers that read the trunk; the encodes keep K = 64
    and 32. Its two head segments are those of ``weights``. Each pack
    holds ``None`` in the other's fields.
    """

    weights: torch.Tensor
    biases: torch.Tensor
    segments: Dict[str, Tuple[int, int, int]]
    bias_slots: Dict[str, Tuple[int, int]]
    layout: np.ndarray
    mma_wt: Optional[torch.Tensor]
    layout_mma: Optional[np.ndarray]
    width: int
    v_width: int
    depth: int
    ldw: int
    ldv: int
    dtype: str
    weights_tc: Optional[torch.Tensor] = None
    layout_tc: Optional[np.ndarray] = None
    weights_f32tc: Optional[torch.Tensor] = None
    layout_f32tc: Optional[np.ndarray] = None

    @property
    def wide(self) -> bool:
        """Whether K1 and K2 run their wide kernels on this pack."""
        return not narrow_dims(self.width, self.v_width, self.depth)

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
    if not supports_dims(width, v_width, depth):
        raise ValueError(
            f"fused kernel serves width, v_width <= {MAX_WIDTH} and depth <= "
            f"{MAX_DEPTH}; got width={width}, v_width={v_width}, depth={depth}")
    ldw, ldv = _round_up(width, 8), _round_up(v_width, 8)
    device = params["dense0"]["kernel"].device
    slots = NARROW_MAX_DEPTH if narrow_dims(width, v_width, depth) else MAX_DEPTH

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
    pieces, pieces_wt = [], []
    offsets_wt: Dict[str, int] = {}
    off = off_wt = 0
    for name, m, rows, ld in mats:
        padded = torch.zeros((rows, ld), dtype=torch.float32, device=device)
        padded[:m.shape[0], :m.shape[1]] = m
        size = _round_up(rows * ld, _ALIGN)
        pieces.append(torch.nn.functional.pad(padded.reshape(-1), (0, size - rows * ld)))
        segments[name] = (off, rows, ld)
        off += size
        # K2's f32 pack (rows, ld: multiples of 8).
        if dtype == "float32" and name not in ("alpha", "rgb"):
            pieces_wt.append(mma_tile(padded.t(), _round_up(ld, 16), rows))
            offsets_wt[name] = off_wt
            off_wt += pieces_wt[-1].numel()
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

    def table(offsets: Dict[str, int]) -> np.ndarray:
        """A forward kernel's offset table: weight segments at ``offsets``,
        then the biases, in csrc/fused_mlp_common.cuh's order."""
        return np.array(
            [offsets.get(f"dense{i}", -1) for i in range(slots)]
            + [offsets.get(f"dense{i}_enc", -1) for i in range(slots)]
            + [offsets[n] for n in ("alpha", "bottleneck", "viewdirs", "viewdirs_dir", "rgb")]
            + [bias_slots[f"dense{i}"][0] if i < depth else -1 for i in range(slots)]
            + [bias_slots[n][0] for n in ("alpha", "bottleneck", "viewdirs", "rgb")],
            dtype=np.int64)

    layout = table({name: off for name, (off, _, _) in segments.items()})

    def tensor_core_pack(tile, heads: bool):
        """The layer segments tiled by ``tile`` (widths, and the K of the
        layers that read the trunk, padded to 64), with the heads as
        ``weights`` holds them or absent (-1); -> (flat f32, table)."""
        nw, nv = _round_up(ldw, _TC_PIECE), _round_up(ldv, _TC_PIECE)
        offsets: Dict[str, int] = {}
        flats = []
        off = 0
        for (name, m, rows, ld), flat in zip(mats, pieces):
            if name in ("alpha", "rgb"):          # the heads run on the CUDA cores
                if not heads:
                    offsets[name] = -1
                    continue
                piece = flat
            else:
                encoded = name in ("dense0", "viewdirs_dir") or name.endswith("_enc")
                piece = tile(m, rows if encoded else nw, nw if ld == ldw else nv)
            flats.append(piece)
            offsets[name] = off
            off += piece.numel()
        return torch.cat(flats), table(offsets)

    mma_wt = layout_mma = weights_tc = layout_tc = weights_f32tc = layout_f32tc = None
    if dtype == "float32":
        mma_wt = torch.stack(tf32_split(torch.cat(pieces_wt)))
        layout_mma = np.array(
            [offsets_wt.get(f"dense{i}", -1) for i in range(slots)]
            + [offsets_wt.get(f"dense{i}_enc", -1) for i in range(slots)]
            + [offsets_wt[n] for n in ("bottleneck", "viewdirs", "viewdirs_dir")],
            dtype=np.int64)
        weights_f32tc, layout_f32tc = tensor_core_pack(f32tc_tile, heads=False)
        weights_f32tc = weights_f32tc.to(torch.bfloat16)    # exact: the pieces are bf16 values
    else:
        weights_tc, layout_tc = tensor_core_pack(tc_tile, heads=True)
        weights_tc = weights_tc.to(torch.bfloat16)
    return PackedMLP(weights=weights, biases=biases, segments=segments,
                     bias_slots=bias_slots, layout=layout, mma_wt=mma_wt,
                     layout_mma=layout_mma, width=width, v_width=v_width, depth=depth,
                     ldw=ldw, ldv=ldv, dtype=dtype, weights_tc=weights_tc,
                     layout_tc=layout_tc, weights_f32tc=weights_f32tc,
                     layout_f32tc=layout_f32tc)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x``: ``hi = tf32_rna(x)``, ``lo =
    tf32_rna(x - hi)``, each a float32 whose low 13 mantissa bits are zero,
    as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero). The
    3xTF32 product hi·hi + hi·lo + lo·hi of two split operands is within
    about 2^-21 of the f32 product."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # Adding half a tf32 ulp to the magnitude bits rounds half away from
    # zero; the mask drops the 13 bits tf32 does not keep.
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mma_tile(m: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """A (K, N) matrix zero-padded to (k, n), flat in the order the f32
    backward kernel loads ``mma.sync`` tf32 B fragments
    (``csrc/fused_mlp_bwd_tc.cu``): one block of 16 k x 8 n per (k // 16,
    n // 8), row-major over blocks; in a block, lane ``4 g + t`` of a warp
    holds its four elements at ``4 (4 g + t) + j``, all at column
    ``8 nb + g`` and rows ``16 kb + t + 4 j`` (j = 0, 1 are ``m16n8k8``'s
    b0, b1 for the first eight k, j = 2, 3 for the next). k must be a
    multiple of 16, n of 8. Returns float32; the caller splits."""
    if k % 16 or n % 8 or m.shape[0] > k or m.shape[1] > n:
        raise ValueError(f"cannot tile a {tuple(m.shape)} matrix to ({k}, {n})")
    padded = torch.zeros((k, n), dtype=torch.float32, device=m.device)
    padded[:m.shape[0], :m.shape[1]] = m
    t, j = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    rows = t + 4 * j
    blocks = padded.reshape(k // 16, 16, n // 8, 8).permute(0, 2, 3, 1)   # kb, nb, g, row
    idx = torch.as_tensor(rows.reshape(-1), device=m.device)
    return blocks[..., idx].reshape(-1)


def tc_tile(m: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """A (K, N) weight matrix zero-padded to (k, n), flat in the order the
    tensor-core forward copies it into shared memory and ``wgmma`` reads
    it: for B = W (K x N) "K-major", 8 x 8 core matrices of 8 n-rows of 8
    consecutive k (16 bytes a row, 128 a matrix), the core matrix of k
    group kg and n group ng at ``(kg * n / 8 + ng) * 64`` elements. Every
    64 consecutive k rows (one bulk copy) are one contiguous run of
    ``64 * n`` elements. k must be a multiple of 16 (a bf16 ``wgmma``
    k-step), n of 64."""
    if k % 16 or n % _TC_PIECE or m.shape[0] > k or m.shape[1] > n:
        raise ValueError(f"cannot tile a {tuple(m.shape)} matrix to ({k}, {n})")
    padded = torch.zeros((k, n), dtype=torch.float32, device=m.device)
    padded[:m.shape[0], :m.shape[1]] = m
    return padded.reshape(k // 8, 8, n // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def bf16_split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo) of float32 ``x``, each a float32 that bf16 holds
    exactly: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi -
    mid)``, rounded to nearest even, as ``csrc/fused_mlp_f32tc.cuh::split3``
    splits. Both subtractions are exact and ``hi + mid + lo == x`` (but
    where ``lo`` would fall below bf16's smallest normal)."""
    def bf16(v):
        return v.to(torch.bfloat16).to(torch.float32)

    x = x.to(torch.float32)
    hi = bf16(x)
    mid = bf16(x - hi)
    return hi, mid, bf16(x - hi - mid)


def f32tc_tile(m: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """A (K, N) weight matrix zero-padded to (k, n), split by
    :func:`bf16_split3`, flat in the order the f32 tensor-core kernels copy
    it: per chunk of 16 k rows (one ``wgmma`` k-step, one bulk copy), its
    hi, mid and lo planes back to back, each in :func:`tc_tile`'s
    core-matrix order. k must be a multiple of 16, n of 64. Returns
    float32 (bf16 values)."""
    if k % _STEP_K or n % _TC_PIECE or m.shape[0] > k or m.shape[1] > n:
        raise ValueError(f"cannot tile a {tuple(m.shape)} matrix to ({k}, {n})")
    padded = torch.zeros((k, n), dtype=torch.float32, device=m.device)
    padded[:m.shape[0], :m.shape[1]] = m
    planes = torch.stack(bf16_split3(padded))                  # plane, k, n
    blocks = planes.reshape(3, k // _STEP_K, 2, 8, n // 8, 8)   # plane, chunk, kg, k%8, ng, n%8
    return blocks.permute(1, 0, 2, 4, 5, 3).reshape(-1)


def split_f32_dense(sources, b: torch.Tensor, group: Optional[int] = None) -> torch.Tensor:
    """:func:`_dense` in the f32 kernels' arithmetic as built
    (``csrc/fused_mlp_f32tc.cuh``), for the CPU tests: each operand split by
    :func:`bf16_split3`; the sources in order, each in k-steps of 16 (zero
    padding adds nothing); per k-step the six piece products of
    ``SPLIT_F32_ORDER``, each added with one rounding (its 16 products
    summed in float64) to its float32 accumulator: hi.hi to the big one,
    the other five to the small one; then (big + small) + b. Float32 in
    and out.

    With ``group``, the arithmetic studied for a split-f32 route of the
    wide f32 kernel (tools/torch_wide_split_f32_groups.py): the big
    accumulator takes the hi.hi products of ``group`` k-steps at a time,
    counted over the layer's sources in order, and each group's sum is
    added, rounded, to a running sum once it ends: ((g0 + g1) + g2) ...,
    then (that + small) + b. A group as long as the layer is the narrow
    kernel's arithmetic."""
    big = small = total = None

    def add(acc, term):
        return term.float() if acc is None else (acc.double() + term).float()

    step = 0
    for a, w in sources:
        xs, ws = bf16_split3(a), bf16_split3(w)
        for k0 in range(0, a.shape[-1], _STEP_K):
            if group and step and step % group == 0:
                total = big if total is None else total + big
                big = None
            for i, j in SPLIT_F32_ORDER:
                term = xs[i][:, k0:k0 + _STEP_K].double() @ ws[j][k0:k0 + _STEP_K].double()
                if i == j == 0:
                    big = add(big, term)
                else:
                    small = add(small, term)
            step += 1
    if total is not None:
        big = total + big
    return (big + small) + b


def _packed(params, dtype: str) -> PackedMLP:
    """A pack itself, the pack of a NerfMLP (kept by the module), or the
    pack of a param tree."""
    if isinstance(params, PackedMLP):
        if params.dtype != dtype:
            raise ValueError(f"pack holds {params.dtype} weights, call asks for {dtype}")
        return params
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


def _encode_vjp(x: torch.Tensor, de: torch.Tensor, freqs: int) -> torch.Tensor:
    """d(x) from d(positional_encoding(x)) ``de`` (rows past 3 + 6 freqs
    ignored): identity rows give 1, sin rows 2^b cos(2^b x), cos rows
    -2^b sin(2^b x)."""
    out = de[:, :3]
    for b in range(freqs):
        scale = float(2 ** b)
        arg = x * scale
        out = (out + de[:, 3 + 6 * b:6 + 6 * b] * (scale * torch.cos(arg))
               - de[:, 6 + 6 * b:9 + 6 * b] * (scale * torch.sin(arg)))
    return out


def _rounder(dtype: str):
    if dtype == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(x.dtype)
    return lambda x: x


def _flat_inputs(points: torch.Tensor, viewdirs: torch.Tensor, dt=torch.float32):
    pts = points.reshape(-1, 3).to(dt)
    dirs = torch.broadcast_to(viewdirs, points.shape).reshape(-1, 3).to(dt)
    return pts, dirs


def _dense(sources, b: torch.Tensor) -> torch.Tensor:
    """A layer's pre-activation, sum of ``a @ w`` over its (a, w)
    sources, in the kernels' order (a skip layer's encode part first, the
    view layer's trunk part first), plus the bias ``b``. The CPU tests swap
    in :func:`split_f32_dense` to run the f32 kernels' arithmetic."""
    acc = sources[0][0] @ sources[0][1]
    for a, w in sources[1:]:
        acc = acc + a @ w
    return acc + b


def _trunk(mat, bias, enc_x: torch.Tensor, rnd, depth: int, skips, keep: bool = True):
    """Every trunk layer's output, as the kernels compute them (without
    ``keep``, the last one only: a forward needs no more)."""
    hs = [rnd(torch.relu(_dense([(enc_x, mat("dense0"))], bias("dense0"))))]
    for i in range(1, depth):
        sources = [(hs[-1], mat(f"dense{i}"))]
        if f"dense{i}_enc" in skips:
            sources.insert(0, (enc_x, mat(f"dense{i}_enc")))
        hs.append(rnd(torch.relu(_dense(sources, bias(f"dense{i}")))))
        if not keep:
            del hs[0]
    return hs


def _color_branch(mat, bias, h: torch.Tensor, enc_d: torch.Tensor, rnd):
    """The bottleneck's output (no activation) and the view layer's, as
    the kernels compute them."""
    bneck = rnd(_dense([(h, mat("bottleneck"))], bias("bottleneck")))
    hv = rnd(torch.relu(_dense([(bneck, mat("viewdirs")), (enc_d, mat("viewdirs_dir"))],
                               bias("viewdirs"))))
    return bneck, hv


def fused_nerf_mlp_reference(params, points: torch.Tensor, viewdirs: torch.Tensor, *,
                             x_freqs: int = 10, d_freqs: int = 4, dtype: str = "float32",
                             sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain PyTorch version: same function, same
    packed weights, same bf16 rounding points; only the f32 summation
    order differs. Any device. It reads the weights through the pack,
    which holds detached copies: torch autograd reaches points and
    viewdirs through it but never the parameters. :func:`fused_nerf_mlp`
    is the differentiable entry point. The arithmetic is float32, or
    float64 for float64 points: the same function, rounded where the
    kernel rounds, without its summation error."""
    _check_call(x_freqs, d_freqs, dtype)
    pk = _packed(params, dtype)
    rnd = _rounder(dtype)
    batch = points.shape[:-1]
    dt = torch.float64 if points.dtype == torch.float64 else torch.float32
    pts, dirs = _flat_inputs(points, viewdirs, dt)

    def mat(name):
        return pk.mat(name).to(dt)

    def bias(name):
        return pk.bias(name).to(dt)

    enc_x = rnd(_encode(pts, x_freqs, _ENC_X))
    h = _trunk(mat, bias, enc_x, rnd, pk.depth, pk.segments, keep=False)[-1]
    sigma = torch.relu(h @ mat("alpha") + bias("alpha"))[:, 0]
    if sigma_only:
        rgb = torch.zeros((pts.shape[0], 3), dtype=dt, device=pts.device)
    else:
        enc_d = rnd(_encode(dirs, d_freqs, _ENC_D))
        bneck, hv = _color_branch(mat, bias, h, enc_d, rnd)
        rgb = torch.sigmoid(hv @ mat("rgb") + bias("rgb"))
    return rgb.reshape(*batch, 3), sigma.reshape(batch)


BF16_SIGMA_BARS = (2e-2, 2e-2)   # atol, rtol: tests/test_fused_mlp.py's bars for two bf16 orders


def bf16_sigma_agrees(sig_kernel: torch.Tensor, sig_plain: torch.Tensor,
                      sig_exact: torch.Tensor) -> Tuple[bool, Dict[str, int]]:
    """Whether the bf16 forward kernel's sigma agrees with its plain
    version's, on the same inputs.

    A bf16 rounding that the kernel's tensor-core sums and the plain
    version's f32 sums round apart cascades through the trunk, so a bar on
    every sample holds only for one summation order. Both are held to
    ``sig_exact``, the plain version on float64 inputs (the same function
    without summation error): the kernel may leave at most twice as many
    samples outside ``BF16_SIGMA_BARS`` of it as the plain version does,
    plus 2. As a backstop, at most 4 + 5e-5 n of its n samples may lie
    outside the bars of the plain version itself (fewer than one
    128-sample tile at the render's shapes). -> (ok, the three counts).
    """
    atol, rtol = BF16_SIGMA_BARS

    def outside(got, want):
        got, want = got.double().reshape(-1), want.double().reshape(-1)
        return int(((got - want).abs() > atol + rtol * want.abs()).sum())

    counts = {"kernel_vs_plain": outside(sig_kernel, sig_plain),
              "kernel_vs_exact": outside(sig_kernel, sig_exact),
              "plain_vs_exact": outside(sig_plain, sig_exact)}
    ok = (counts["kernel_vs_exact"] <= 2 * counts["plain_vs_exact"] + 2
          and counts["kernel_vs_plain"] <= 4 + 5e-5 * sig_kernel.numel())
    return ok, counts


def fused_nerf_mlp_backward_reference(params, points: torch.Tensor, viewdirs: torch.Tensor,
                                      g_rgb: torch.Tensor, g_sigma: torch.Tensor, *,
                                      x_freqs: int = 10, d_freqs: int = 4,
                                      dtype: str = "float32", sigma_only: bool = False,
                                      input_grads: bool = True):
    """The backward kernel's plain PyTorch version: the gradients of
    ``sum(g_rgb * rgb) + sum(g_sigma * sigma)`` for the forward above, in
    the JAX kernel's order and with its bf16 rounding points.

    Returns ``(dweights, dbiases, dpoints, dviewdirs)``: ``dweights`` flat
    in the layout of ``PackedMLP.weights``, ``dbiases`` in that of
    ``PackedMLP.biases`` (padding entries zero), ``dpoints`` shaped like
    points and ``dviewdirs`` one row per sample, also shaped like points
    (``None, None`` without ``input_grads``). With ``sigma_only`` the rgb
    cotangent is ignored, and the color branch's gradients are zero. The
    arithmetic is float32, or float64 for float64 points: the same
    function, rounded where the kernel rounds, as an oracle for both.
    """
    _check_call(x_freqs, d_freqs, dtype)
    pk = _packed(params, dtype)
    rnd = _rounder(dtype)
    dt = torch.float64 if points.dtype == torch.float64 else torch.float32
    pts, dirs = _flat_inputs(points, viewdirs, dt)
    g_rgb = g_rgb.reshape(-1, 3).to(dt)
    g_sigma = g_sigma.reshape(-1, 1).to(dt)
    dweights = torch.zeros(pk.weights.numel(), dtype=dt, device=pts.device)
    dbiases = torch.zeros_like(pk.biases, dtype=dt)

    def mat(name):
        return pk.mat(name).to(dt)

    def bias(name):
        return pk.bias(name).to(dt)

    def grad_wb(name, dz, x):
        off, k, ld = pk.segments[name]
        dweights[off:off + k * ld] = (x.t() @ dz).reshape(-1)
        if name in pk.bias_slots:
            boff, nb = pk.bias_slots[name]
            dbiases[boff:boff + nb] = dz.sum(0)

    with torch.no_grad():
        enc_x = rnd(_encode(pts, x_freqs, _ENC_X))
        hs = _trunk(mat, bias, enc_x, rnd, pk.depth, pk.segments)
        h = hs[-1]
        pre = h @ mat("alpha") + bias("alpha")
        ds = rnd(g_sigma * (pre > 0))
        grad_wb("alpha", ds, h)
        dh = ds @ mat("alpha").t()
        de_d = None
        if not sigma_only:
            enc_d = rnd(_encode(dirs, d_freqs, _ENC_D))
            bneck, hv = _color_branch(mat, bias, h, enc_d, rnd)
            pre = hv @ mat("rgb") + bias("rgb")
            # sigmoid' = sg (1 - sg), with 1 - sg as sigmoid(-pre): no
            # cancellation where the sigmoid saturates (JAX subtracts).
            dr = rnd(g_rgb * torch.sigmoid(pre) * torch.sigmoid(-pre))
            grad_wb("rgb", dr, hv)
            dhv = rnd((dr @ mat("rgb").t()) * (hv > 0))
            grad_wb("viewdirs", dhv, bneck)
            grad_wb("viewdirs_dir", dhv, enc_d)
            dbn = rnd(dhv @ mat("viewdirs").t())
            de_d = dhv @ mat("viewdirs_dir").t()
            grad_wb("bottleneck", dbn, h)
            dh = dbn @ mat("bottleneck").t() + dh
        dh = rnd(dh * (h > 0))
        de_x = torch.zeros_like(enc_x)
        for i in range(pk.depth - 1, 0, -1):
            hin = hs[i - 1]
            grad_wb(f"dense{i}", dh, hin)
            if f"dense{i}_enc" in pk.segments:
                grad_wb(f"dense{i}_enc", dh, enc_x)
                de_x = de_x + dh @ mat(f"dense{i}_enc").t()
            dh = rnd((dh @ mat(f"dense{i}").t()) * (hin > 0))
        grad_wb("dense0", dh, enc_x)
        if not input_grads:
            return dweights, dbiases, None, None
        de_x = de_x + dh @ mat("dense0").t()
        dpts = _encode_vjp(pts, de_x, x_freqs)
        ddirs = torch.zeros_like(dpts) if de_d is None else _encode_vjp(dirs, de_d, d_freqs)
    return dweights, dbiases, dpts.reshape(points.shape), ddirs.reshape(points.shape)


def unpack_grads(packed: PackedMLP, dweights: torch.Tensor,
                 dbiases: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """Map gradients in the packed layout (``dweights`` like
    ``packed.weights``, ``dbiases`` like ``packed.biases``) back to the
    param tree's layout; padding entries are ignored."""
    w, v = packed.width, packed.v_width

    def seg(name, rows, cols):
        off, k, ld = packed.segments[name]
        return dweights[off:off + k * ld].view(k, ld)[:rows, :cols]

    def bias(name, n):
        off, _ = packed.bias_slots[name]
        return dbiases[off:off + n]

    out = {"dense0": {"kernel": seg("dense0", _ENC_X_RAW, w), "bias": bias("dense0", w)}}
    for i in range(1, packed.depth):
        kernel = seg(f"dense{i}", w, w)
        if f"dense{i}_enc" in packed.segments:
            kernel = torch.cat([seg(f"dense{i}_enc", _ENC_X_RAW, w), kernel])
        out[f"dense{i}"] = {"kernel": kernel, "bias": bias(f"dense{i}", w)}
    out["alpha"] = {"kernel": seg("alpha", w, 1), "bias": bias("alpha", 1)}
    out["bottleneck"] = {"kernel": seg("bottleneck", w, w), "bias": bias("bottleneck", w)}
    out["viewdirs"] = {"kernel": torch.cat([seg("viewdirs", w, v),
                                            seg("viewdirs_dir", _ENC_D_RAW, v)]),
                       "bias": bias("viewdirs", v)}
    out["rgb"] = {"kernel": seg("rgb", v, 3), "bias": bias("rgb", 3)}
    return out


def _kernel_inputs(pk: PackedMLP, points: torch.Tensor, viewdirs: torch.Tensor):
    """Check what the kernels take; -> (dirs, dir_div, batch shape, n)."""
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
    if pk.weights.device != points.device:
        raise ValueError(f"packed weights on {pk.weights.device}, points on {points.device}")
    if viewdirs.shape == points.shape:
        dirs, dir_div = viewdirs, 1
    elif points.dim() >= 2 and viewdirs.shape == (*points.shape[:-2], 1, 3):
        dirs, dir_div = viewdirs, points.shape[-2]      # one dir per ray
    else:
        dirs, dir_div = torch.broadcast_to(viewdirs, points.shape).contiguous(), 1
    if not dirs.is_contiguous():
        raise ValueError("viewdirs must be contiguous")
    return dirs, dir_div, points.shape[:-1], points.numel() // 3


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward_kernel(pk: PackedMLP, points: torch.Tensor, viewdirs: torch.Tensor,
                    sigma_only: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, on the current stream, without synchronizing:
    f32 packs launch the split-f32 kernel (``csrc/fused_mlp_f32tc.cu``),
    bf16 packs ``csrc/fused_mlp_tc.cu``; both on the tensor cores, counted
    also in ``fused_nerf_mlp.tc_launches``. Wide packs launch
    ``csrc/fused_mlp_wide_tc.cu`` (bf16, tensor cores, thread-block
    clusters) or
    ``csrc/fused_mlp_wide_f32.cu`` (f32, CUDA cores), counted also in
    ``fused_nerf_mlp.wide_launches``."""
    dirs, dir_div, batch, n = _kernel_inputs(pk, points, viewdirs)
    rgb = torch.empty((*batch, 3), dtype=torch.float32, device=points.device)
    sigma = torch.empty(batch, dtype=torch.float32, device=points.device)
    if n == 0:
        return rgb, sigma
    lib = _build.load_library()
    head = (points.data_ptr(), dirs.data_ptr(), n, dir_div)
    tail = (pk.ldw, pk.ldv, pk.depth, int(sigma_only), rgb.data_ptr(), sigma.data_ptr(),
            points.device.index or 0, _stream(points.device))
    tensor_cores = not (pk.wide and pk.dtype == "float32")
    if pk.wide and pk.dtype == "bfloat16":
        err = lib.nerf_fused_mlp_wide_tc_forward(
            *head, pk.weights_tc.data_ptr(), pk.biases.data_ptr(), pk.layout_tc.ctypes.data,
            pk.layout_tc.size, *tail)
    elif pk.wide:
        err = lib.nerf_fused_mlp_wide_f32_forward(
            *head, pk.weights.data_ptr(), pk.biases.data_ptr(), pk.layout.ctypes.data,
            pk.layout.size, *tail)
    elif pk.dtype == "bfloat16":
        err = lib.nerf_fused_mlp_tc_forward(*head, pk.weights_tc.data_ptr(), pk.biases.data_ptr(),
                                            pk.layout_tc.ctypes.data, pk.layout_tc.size, *tail)
    else:
        err = lib.nerf_fused_mlp_f32tc_forward(
            *head, pk.weights.data_ptr(), pk.weights_f32tc.data_ptr(), pk.biases.data_ptr(),
            pk.layout.ctypes.data, pk.layout_f32tc.ctypes.data, pk.layout.size, *tail)
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed with CUDA error {err}")
    fused_nerf_mlp.launches += 1
    fused_nerf_mlp.tc_launches += int(tensor_cores)
    fused_nerf_mlp.wide_launches += int(pk.wide)
    return rgb, sigma


_F32_ROUND_TILES = 8         # tiles a CTA takes a round in the narrow f32 backward


def _backward_f32(lib, pk: PackedMLP, ptrs, partials, grid: int, tiles: int, sigma_only: bool,
                  outs) -> int:
    """K2's narrow f32 mode: round by round, K1 f32's record mode
    (``nerf_fused_mlp_f32tc_record``: the recompute, every layer's output
    into the round's workspace) and ``csrc/fused_mlp_bwd_tc.cu`` over the
    same 128-sample tiles, each CTA taking the same tiles of each round,
    then the fixed-order sum of the partials. The workspace holds a round:
    grid x _F32_ROUND_TILES tiles, each its encodes, trunk, bottleneck and
    view outputs. -> a cudaError_t value."""
    points, dirs, n, dir_div = ptrs[:4]
    per_round = grid * _F32_ROUND_TILES
    ws = torch.empty(min(tiles, per_round) * _BWD_TILE
                     * (_ENC_X + _ENC_D + (pk.depth + 1) * pk.ldw + pk.ldv),
                     dtype=torch.float32, device=partials.device)
    n_w, n_b = pk.weights.numel(), pk.biases.numel()
    device, stream = outs[-2:]
    pack = (pk.weights.data_ptr(), pk.weights_f32tc.data_ptr(), pk.biases.data_ptr(),
            pk.layout.ctypes.data, pk.layout_f32tc.ctypes.data, pk.layout.size, pk.ldw,
            pk.ldv, pk.depth, int(sigma_only))
    for tile0 in range(0, tiles, per_round):
        rows = min(tiles - tile0, per_round) * _BWD_TILE
        err = lib.nerf_fused_mlp_f32tc_record(points, dirs, n, dir_div, *pack, tile0 * _BWD_TILE,
                                              rows, ws.data_ptr(), device, stream)
        if err == 0:
            err = lib.nerf_fused_mlp_backward(
                *ptrs, pk.weights.data_ptr(), pk.mma_wt.data_ptr(), pk.mma_wt.shape[1],
                pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size,
                pk.layout_mma.ctypes.data, pk.layout_mma.size, pk.ldw, pk.ldv, pk.depth,
                int(sigma_only), ws.data_ptr(), tile0, _F32_ROUND_TILES, partials.data_ptr(),
                n_w, n_b, grid, *outs[2:])
        if err != 0:
            return err
    return lib.nerf_fused_mlp_backward_sum(partials.data_ptr(), grid, n_w, n_b, *outs[:2],
                                           device, stream)


# The wide K2 (past NARROW_MAX_WIDTH or NARROW_MAX_DEPTH) runs in rounds of
# tiles: per round a per-tile kernel (csrc/fused_mlp_wide_bwd_bf16.cu, or
# after the wide f32 forward's record pass csrc/fused_mlp_wide_bwd_tc.cu)
# writes every layer's input H and output gradient dZ to a workspace, and
# the dW kernel (csrc/fused_mlp_wide_dw.cu) sums H^T dZ over the round. The
# round is sized from the bytes: as many tiles a CTA as WIDE_ROUND_BYTES of
# the dtype's workspace (and, in f32, record) hold, at least one. A tile
# takes 1.22 MB in bf16 and 4.94 MB in f32 at 512/256/8 (19.1 KB of
# images a sample, three planes of them in f32, and the record), so the
# budgets give 4 and 3 tiles a CTA there: of the rounds timed there (1, 2
# and these tiles a CTA, tools/torch_wide_k2_profile.py --per-cta), the
# fastest. No round fits the 50 MB L2: one tile a CTA is 161 MB in bf16.
WIDE_ROUND_BYTES = {"bfloat16": 768 * 2 ** 20, "float32": 2048 * 2 ** 20}
_DW_TILE_M = 128             # kTileM of csrc/fused_mlp_wide_dw.cu: input features a job
_DW_JOB_FIELDS = 8           # kJobLen: int64 fields a job
_DW_MIN_SHARE = 0.85         # the dW items' least share of full waves on the SMs
_DW_MAX_SPLITS = 16


def wide_planes(dtype: str) -> int:
    """bf16 planes a workspace value takes: 1 (bf16), or 3 (the hi, mid
    and lo pieces of an f32 value, :func:`bf16_split3`)."""
    return 1 if dtype == "bfloat16" else 3


_DW_TILE_N = 128             # kTileN: output columns a job


def wide_slot_cols(pk: PackedMLP) -> List[int]:
    """Columns of the wide workspace's slots (``csrc/fused_mlp_wide_dw.cuh``),
    in its order: the point and dir encodes, the trunk outputs and the
    bottleneck's, then the gradients of the trunk layers, the bottleneck
    and the view layer; widths padded to 64."""
    nw, nv = _round_up(pk.ldw, _TC_PIECE), _round_up(pk.ldv, _TC_PIECE)
    return [_ENC_X, _ENC_D] + [nw] * (pk.depth + 1) * 2 + [nv]


def _record_floats(pk: PackedMLP) -> int:
    """Floats of one 64-sample tile of the wide f32 record pass's workspace
    (``csrc/fused_mlp_f32tc.cuh``'s ws_stride at 64 rows)."""
    return _WIDE_BWD_TILE * (_ENC_X + _ENC_D + (pk.depth + 1) * pk.ldw + pk.ldv)


def wide_dw_jobs(pk: PackedMLP, sigma_only: bool) -> np.ndarray:
    """The dW kernel's jobs: one row of ``_DW_JOB_FIELDS`` int64 a job (an
    output tile of one segment: ``_DW_TILE_M`` input features by
    ``_DW_TILE_N`` columns), in ``csrc/fused_mlp_wide_dw.cu``'s field
    order: the workspace slot of its H and the job's first feature in it,
    the slot of its dZ and the job's first column in it; the gradient's
    offset in dweights, its row stride, and the rows and columns to store.
    Where a slot's images lie is ``csrc/fused_mlp_wide_dw.cuh``'s to say.
    The heads and the biases are summed per CTA instead; sigma-only calls
    have no color-branch jobs."""
    depth = pk.depth
    h = lambda i: 2 + i                 # noqa: E731 (i = depth: the bottleneck)
    dz = lambda i: 3 + depth + i        # noqa: E731 (i = depth: the bottleneck)
    dz_view = 4 + 2 * depth
    segs = [("dense0", 0, dz(0))]
    for i in range(1, depth):
        if f"dense{i}_enc" in pk.segments:
            segs.append((f"dense{i}_enc", 0, dz(i)))
        segs.append((f"dense{i}", h(i - 1), dz(i)))
    if not sigma_only:
        segs += [("bottleneck", h(depth - 1), dz(depth)), ("viewdirs", h(depth), dz_view),
                 ("viewdirs_dir", 1, dz_view)]
    jobs = []
    for name, a, b in segs:
        off, k, ld = pk.segments[name]
        for m0 in range(0, k, _DW_TILE_M):
            for n0 in range(0, ld, _DW_TILE_N):
                jobs.append([a, m0, b, n0, off + m0 * ld + n0, ld, min(_DW_TILE_M, k - m0),
                             min(_DW_TILE_N, ld - n0)])
    return np.array(jobs, dtype=np.int64).reshape(-1, _DW_JOB_FIELDS)


def wide_dw_splits(n_jobs: int, sms: int, round_tiles: int) -> int:
    """Slices of a round's tiles that each dW job is cut into: the fewest
    that fill ``_DW_MIN_SHARE`` of whole waves of ``sms`` CTAs with its
    n_jobs x splits items, else the best share up to ``_DW_MAX_SPLITS``;
    never more than the round's tiles."""
    best, best_share = 1, 0.0
    for s in range(1, min(_DW_MAX_SPLITS, round_tiles) + 1):
        items = n_jobs * s
        share = items / (-(-items // sms) * sms)
        if share >= _DW_MIN_SHARE:
            return s
        if share > best_share + 1e-9:
            best, best_share = s, share
    return best


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """How the wide K2 runs one call: ``tiles`` tiles of 64 samples on
    ``grid`` CTAs, in rounds of ``round_tiles`` (the last may be ragged),
    each round's dW jobs cut into ``splits`` slices; the scratch each
    buffer takes, in bytes (``record`` is the f32 record pass's round)."""

    tiles: int
    grid: int
    round_tiles: int
    rounds: int
    planes: int
    jobs: np.ndarray
    splits: int
    small_stride: int
    ws_bytes: int
    record_bytes: int
    part_bytes: int
    small_bytes: int
    de_bytes: int

    @property
    def scratch_bytes(self) -> int:
        return (self.ws_bytes + self.record_bytes + self.part_bytes + self.small_bytes
                + self.de_bytes)

    def round_splits(self, tiles: int) -> int:
        """Slices of a round of ``tiles`` tiles (the ragged last: fewer)."""
        return min(self.splits, tiles)


def wide_plan(pk: PackedMLP, n: int, sms: int, sigma_only: bool) -> WidePlan:
    """The wide K2's plan for ``n`` samples on a card of ``sms`` SMs."""
    budget = WIDE_ROUND_BYTES[pk.dtype]
    tiles = -(-n // _WIDE_BWD_TILE)
    grid = min(tiles, sms)
    planes = wide_planes(pk.dtype)
    tile_ws = 128 * planes * sum(wide_slot_cols(pk))
    tile_rec = 4 * _record_floats(pk) if pk.dtype == "float32" else 0
    per_cta = max(1, min(budget // (grid * (tile_ws + tile_rec)), -(-tiles // grid)))
    round_tiles = min(grid * per_cta, tiles)
    jobs = wide_dw_jobs(pk, sigma_only)
    splits = wide_dw_splits(len(jobs), sms, round_tiles)
    small_stride = pk.biases.numel() + pk.ldw + 3 * pk.ldv
    return WidePlan(
        tiles=tiles, grid=grid, round_tiles=round_tiles, rounds=-(-tiles // round_tiles),
        planes=planes, jobs=jobs, splits=splits, small_stride=small_stride,
        ws_bytes=tile_ws * round_tiles, record_bytes=tile_rec * round_tiles,
        part_bytes=4 * splits * len(jobs) * _DW_TILE_M * _DW_TILE_N,
        small_bytes=4 * grid * small_stride,
        de_bytes=4 * grid * _WIDE_BWD_TILE * _ENC_X if pk.dtype == "bfloat16" else 0)


def _backward_wide(lib, pk: PackedMLP, ptrs, n: int, sigma_only: bool, outs, dev: torch.device,
                   sms: int) -> int:
    """K2 on a wide pack (:func:`wide_plan`): per round the record pass (f32:
    ``nerf_fused_mlp_wide_f32_record``), the per-tile kernel
    (``nerf_wide_bwd_bf16_tiles`` or ``nerf_wide_bwd_f32_tiles``) and the
    dW kernel (``nerf_wide_dw``, counted in
    ``fused_nerf_mlp_backward.dw_launches``); then the per-CTA sums of the
    biases and heads (``nerf_wide_small_sum``). Scratch on ``dev``, the
    plan for ``sms`` SMs. -> a cudaError_t value."""
    dweights, dbiases, dpts, ddirs, device, stream = outs
    plan = wide_plan(pk, n, sms, sigma_only)
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    small = torch.zeros(plan.small_bytes // 4, dtype=torch.float32, device=dev)
    part = torch.empty(plan.part_bytes // 4, dtype=torch.float32, device=dev)
    jobs = torch.from_numpy(plan.jobs).to(dev)
    n_b = pk.biases.numel()
    points, dirs, _, dir_div = ptrs[:4]
    if pk.dtype == "float32":
        rec = torch.empty(plan.record_bytes // 4, dtype=torch.float32, device=dev)
        de = None
    else:
        rec = None
        de = torch.empty(plan.de_bytes // 4, dtype=torch.float32, device=dev)
    for tile0 in range(0, plan.tiles, plan.round_tiles):
        tiles = min(plan.tiles - tile0, plan.round_tiles)
        if pk.dtype == "float32":
            err = lib.nerf_fused_mlp_wide_f32_record(
                points, dirs, n, dir_div, pk.weights.data_ptr(), pk.biases.data_ptr(),
                pk.layout.ctypes.data, pk.layout.size, pk.ldw, pk.ldv, pk.depth,
                int(sigma_only), tile0 * _WIDE_BWD_TILE, tiles * _WIDE_BWD_TILE, rec.data_ptr(),
                device, stream)
            if err == 0:
                err = lib.nerf_wide_bwd_f32_tiles(
                    *ptrs, pk.weights.data_ptr(), pk.mma_wt.data_ptr(), pk.mma_wt.shape[1],
                    pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size,
                    pk.layout_mma.ctypes.data, pk.layout_mma.size, pk.ldw, pk.ldv, pk.depth,
                    int(sigma_only), rec.data_ptr(), ws.data_ptr(), plan.round_tiles, tile0,
                    tiles, small.data_ptr(), n_b, plan.small_stride, plan.grid, dpts, ddirs,
                    device, stream)
        else:
            err = lib.nerf_wide_bwd_bf16_tiles(
                *ptrs, pk.weights_tc.data_ptr(), pk.biases.data_ptr(), pk.layout_tc.ctypes.data,
                pk.layout_tc.size, pk.ldw, pk.ldv, pk.depth, int(sigma_only), ws.data_ptr(),
                plan.round_tiles, tile0, tiles, small.data_ptr(), n_b, plan.small_stride,
                de.data_ptr(), plan.grid, dpts, ddirs, device, stream)
        if err == 0:
            splits = plan.round_splits(tiles)
            err = lib.nerf_wide_dw(ws.data_ptr(), plan.round_tiles, jobs.data_ptr(),
                                   len(plan.jobs), splits, tiles, plan.planes, pk.ldw, pk.ldv,
                                   pk.depth, part.data_ptr(), dweights,
                                   min(len(plan.jobs) * splits, sms), device, stream)
            fused_nerf_mlp_backward.dw_launches += int(err == 0)
        if err != 0:
            return err
    return lib.nerf_wide_small_sum(small.data_ptr(), plan.grid, plan.small_stride, n_b, pk.ldw,
                                   pk.segments["alpha"][0], pk.segments["rgb"][0], dweights,
                                   dbiases, device, stream)


def _ws_order(rows: int, features: int, device) -> torch.Tensor:
    """Where (sample row, feature) of a workspace slot of ``rows`` x
    ``features`` lies in it (``csrc/fused_mlp_f32tc.cuh``'s ws_index)."""
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(features, device=device)[None, :]
    n8, low = features // 8, r & 15
    return ((((r >> 4) * n8 + (c >> 3)) * 32 + 4 * (c & 7) + (low & 3)) * 4 + (low >> 2))


def recorded_outputs(params, points: torch.Tensor, viewdirs: torch.Tensor) -> List[torch.Tensor]:
    """What K2's f32 mode differentiates: every trunk layer's output, the
    bottleneck's and the view layer's, (n, width) each, as its record pass
    writes them (K1 f32's record mode, or the wide f32 forward's for wide
    packs; each sample's row depends on its own inputs only), from which the
    backward takes its ReLU masks. CPU tensors: the plain version's. Not a
    path of the renderer or the trainer: checks read it (the kernel's own
    mask where a pre-activation lies within f32's resolution of zero)."""
    pk = _packed(params, "float32")
    if points.device.type == "cpu":
        pts, dirs = _flat_inputs(points, viewdirs)
        mat = pk.mat

        def bias(name):
            return pk.bias(name)

        enc_x = _encode(pts, 10, _ENC_X)
        hs = _trunk(mat, bias, enc_x, lambda x: x, pk.depth, pk.segments)
        bneck, hv = _color_branch(mat, bias, hs[-1], _encode(dirs, 4, _ENC_D), lambda x: x)
        return [h[:, :pk.width] for h in hs] + [bneck[:, :pk.width], hv[:, :pk.v_width]]
    dirs, dir_div, _, n = _kernel_inputs(pk, points, viewdirs)
    rows_a_tile = _WIDE_BWD_TILE if pk.wide else _BWD_TILE
    tiles = -(-n // rows_a_tile)
    stride = rows_a_tile * (_ENC_X + _ENC_D + (pk.depth + 1) * pk.ldw + pk.ldv)
    ws = torch.empty(tiles * stride, dtype=torch.float32, device=points.device)
    lib = _build.load_library()
    dev = points.device
    if pk.wide:
        err = lib.nerf_fused_mlp_wide_f32_record(
            points.data_ptr(), dirs.data_ptr(), n, dir_div, pk.weights.data_ptr(),
            pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size, pk.ldw, pk.ldv,
            pk.depth, 0, 0, tiles * rows_a_tile, ws.data_ptr(), dev.index or 0, _stream(dev))
    else:
        err = lib.nerf_fused_mlp_f32tc_record(
            points.data_ptr(), dirs.data_ptr(), n, dir_div, pk.weights.data_ptr(),
            pk.weights_f32tc.data_ptr(), pk.biases.data_ptr(), pk.layout.ctypes.data,
            pk.layout_f32tc.ctypes.data, pk.layout.size, pk.ldw, pk.ldv, pk.depth, 0, 0,
            tiles * rows_a_tile, ws.data_ptr(), dev.index or 0, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused MLP record pass failed with CUDA error {err}")
    ws = ws.view(tiles, stride)
    out = []
    for i, (ld, keep) in enumerate([(pk.ldw, pk.width)] * (pk.depth + 1) + [(pk.ldv, pk.v_width)]):
        off = rows_a_tile * (_ENC_X + _ENC_D + i * pk.ldw)
        order = _ws_order(rows_a_tile, ld, dev).reshape(-1)
        slot = ws[:, off:off + rows_a_tile * ld][:, order].reshape(tiles * rows_a_tile, ld)
        out.append(slot[:n, :keep])
    return out


def fused_nerf_mlp_backward(params, points: torch.Tensor, viewdirs: torch.Tensor,
                            g_rgb: torch.Tensor, g_sigma: torch.Tensor, *, x_freqs: int = 10,
                            d_freqs: int = 4, dtype: str = "float32", sigma_only: bool = False,
                            input_grads: bool = True):
    """The backward kernel K2: the contract of
    :func:`fused_nerf_mlp_backward_reference`, which CPU tensors run.

    CUDA tensors launch K2 on the current stream without synchronizing,
    and count one launch per call in ``fused_nerf_mlp_backward.launches``
    (the kernel and its fixed-order sum of per-CTA partials; bf16 calls
    also in ``fused_nerf_mlp_backward.bf16_launches``, calls on a wide pack
    in ``fused_nerf_mlp_backward.wide_launches``, which run in rounds,
    their dW kernel's launches in ``fused_nerf_mlp_backward.dw_launches``).
    Two calls on the same inputs give bitwise-equal results. K2 serves
    every pack: its envelope is K1's (:func:`supports_backward_arch`).
    """
    if points.device.type == "cpu":
        return fused_nerf_mlp_backward_reference(
            params, points, viewdirs, g_rgb, g_sigma, x_freqs=x_freqs, d_freqs=d_freqs,
            dtype=dtype, sigma_only=sigma_only, input_grads=input_grads)
    if points.device.type != "cuda":
        raise ValueError(f"fused_nerf_mlp_backward takes CPU or CUDA tensors, got {points.device}")
    _check_call(x_freqs, d_freqs, dtype)
    pk = _packed(params, dtype)
    dirs, dir_div, batch, n = _kernel_inputs(pk, points, viewdirs)
    dev = points.device
    g_rgb = g_rgb.to(torch.float32).reshape(n, 3).contiguous()
    g_sigma = g_sigma.to(torch.float32).reshape(n).contiguous()
    n_w, n_b = pk.weights.numel(), pk.biases.numel()
    dweights = torch.zeros(n_w, dtype=torch.float32, device=dev)
    dbiases = torch.zeros(n_b, dtype=torch.float32, device=dev)
    dpts = ddirs = None
    if input_grads:
        dpts = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        ddirs = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if n > 0:
        lib = _build.load_library()
        ptrs = (points.data_ptr(), dirs.data_ptr(), n, dir_div, g_rgb.data_ptr(),
                g_sigma.data_ptr())
        outs = (dweights.data_ptr(), dbiases.data_ptr(),
                dpts.data_ptr() if input_grads else None,
                ddirs.data_ptr() if input_grads else None, dev.index or 0, _stream(dev))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if pk.wide:
            err = _backward_wide(lib, pk, ptrs, n, sigma_only, outs, dev, sms)
        else:
            tiles = -(-n // _BWD_TILE)
            grid = min(tiles, sms)
            partials = torch.zeros(grid * (n_w + n_b), dtype=torch.float32, device=dev)
            if dtype == "bfloat16":
                # Per CTA: the tile's trunk outputs and bottleneck output as
                # shared-memory images (widths padded to 64), then a tile of
                # 64 f32 columns of encode gradient (csrc/fused_mlp_bwd_bf16.cu's
                # workspace).
                nw = _round_up(pk.ldw, _TC_PIECE)
                ws = torch.empty(grid * _BWD_TILE * ((pk.depth + 1) * nw + 2 * _ENC_X),
                                 dtype=torch.bfloat16, device=dev)
                err = lib.nerf_fused_mlp_backward_bf16(
                    *ptrs, pk.weights_tc.data_ptr(), pk.biases.data_ptr(),
                    pk.layout_tc.ctypes.data, pk.layout.ctypes.data, pk.layout.size, pk.ldw,
                    pk.ldv, pk.depth, int(sigma_only), ws.data_ptr(), partials.data_ptr(), n_w,
                    n_b, grid, *outs)
            else:
                err = _backward_f32(lib, pk, ptrs, partials, grid, tiles, sigma_only, outs)
        if err != 0:
            raise RuntimeError(f"fused MLP backward kernel launch failed with CUDA error {err}")
        fused_nerf_mlp_backward.launches += 1
        fused_nerf_mlp_backward.bf16_launches += int(dtype == "bfloat16")
        fused_nerf_mlp_backward.wide_launches += int(pk.wide)
    if not input_grads:
        return dweights, dbiases, None, None
    return dweights, dbiases, dpts.view(*batch, 3), ddirs.view(*batch, 3)


fused_nerf_mlp_backward.launches = 0
fused_nerf_mlp_backward.bf16_launches = 0
fused_nerf_mlp_backward.wide_launches = 0
fused_nerf_mlp_backward.dw_launches = 0


class _FusedMLP(torch.autograd.Function):
    """The fused MLP with its backward, the counterpart of the JAX
    package's ``_make_op`` ``custom_vjp``. The inputs are points, viewdirs
    and the network's parameter tensors, which forward saves: changing one
    in place before backward raises, as autograd does. Forward and
    backward run the kernels on CUDA tensors and the plain versions on CPU
    tensors; points' and viewdirs' gradients are computed only when asked
    for. K1 and K2 serve the same networks, so forward's pack refuses
    every network K2 would.)"""

    @staticmethod
    def forward(ctx, params, opts, names, points, viewdirs, *leaves):
        pk = _packed(params, opts["dtype"])
        if points.device.type == "cpu":
            rgb, sigma = fused_nerf_mlp_reference(pk, points, viewdirs, **opts)
        else:
            rgb, sigma = _forward_kernel(pk, points, viewdirs, opts["sigma_only"])
        ctx.save_for_backward(points, viewdirs, *leaves)
        ctx.pk, ctx.opts, ctx.names = pk, opts, names
        return rgb, sigma

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        points, viewdirs, *_ = ctx.saved_tensors
        want_pts, want_dirs = ctx.needs_input_grad[3:5]
        dweights, dbiases, dpts, ddirs = fused_nerf_mlp_backward(
            ctx.pk, points, viewdirs, g_rgb, g_sigma, input_grads=want_pts or want_dirs,
            **ctx.opts)
        tree = unpack_grads(ctx.pk, dweights, dbiases)
        dleaves = [tree[layer][part] if want else None
                   for (layer, part), want in zip(ctx.names, ctx.needs_input_grad[5:])]
        dpts = dpts.to(points.dtype) if want_pts else None
        ddirs = ddirs.sum_to_size(viewdirs.shape).to(viewdirs.dtype) if want_dirs else None
        return (None, None, None, dpts, ddirs, *dleaves)


def fused_nerf_mlp(params, points: torch.Tensor, viewdirs: torch.Tensor, *,
                   x_freqs: int = 10, d_freqs: int = 4, dtype: str = "float32",
                   sigma_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in fused replacement for ``models.mlp.nerf_mlp``, differentiable
    in the parameters, points and viewdirs on every device.

    ``params`` is a NerfMLP (whose pack is reused) or a param tree (packed
    on every call). points (..., 3) f32, viewdirs (..., 3) f32 broadcastable
    against them -> (rgb (..., 3), sigma (...,)) f32. With ``sigma_only``
    rgb is zeros and the color branch is skipped; an rgb cotangent then
    gives the color branch no gradient.

    CUDA tensors launch K1 (and, in backward, K2) on the current stream
    without synchronizing; CPU tensors run the plain versions. K1 and K2
    serve :func:`supports_arch`; the pack of any other network raises
    ValueError before K1 launches.
    """
    _check_call(x_freqs, d_freqs, dtype)
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_mlp takes CPU or CUDA tensors, got {points.device}")
    tree = params.tree() if hasattr(params, "tree") else params
    names = [(layer, part) for layer in tree for part in ("kernel", "bias")]
    leaves = [tree[layer][part] for layer, part in names]
    opts = dict(x_freqs=x_freqs, d_freqs=d_freqs, dtype=dtype, sigma_only=sigma_only)
    return _FusedMLP.apply(params, opts, names, points, viewdirs, *leaves)


fused_nerf_mlp.launches = 0
fused_nerf_mlp.tc_launches = 0
fused_nerf_mlp.wide_launches = 0
