"""Fused NeRF MLP: the CUDA kernels' wrappers, their weight packing, their
plain PyTorch versions, and the autograd function that joins them.

The forward kernel K1 replaces the JAX package's Pallas kernel
``nerf_rs_tpu/ops/kernels/fused_mlp.py::_forward_t`` / ``_mlp_chain``: per
tile of samples it encodes points and dirs, runs the trunk with the skip
layer as two summed products, the ReLU sigma head and, unless
``sigma_only``, the bottleneck, the view layer (two summed products) and
the sigmoid rgb head, with activations kept on chip. It has two kernels:
float32 on the CUDA cores (``csrc/fused_mlp.cu``) and bfloat16 on the
tensor cores (``csrc/fused_mlp_tc.cu``: ``wgmma`` on weights bulk-copied
into shared memory). The backward kernel K2 (``csrc/fused_mlp_bwd.cu``)
replaces ``_backward_t`` / ``_kernel_bwd``: it recomputes the forward per
tile, backpropagates, and sums every layer's weight and bias gradient
over the samples.

- :func:`pack_params` lays the weights out for the kernels, once per
  network and dtype (``models.mlp.NerfMLP.packed`` keeps the pack).
- :func:`fused_nerf_mlp` is differentiable on every device, through
  :class:`_FusedMLP` (the counterpart of ``_make_op``'s ``custom_vjp``).
  On CUDA tensors its forward launches K1 (counted in
  ``fused_nerf_mlp.launches``, the bf16 tensor-core launches also in
  ``fused_nerf_mlp.tc_launches``) and its backward K2 (counted in
  ``fused_nerf_mlp_backward.launches``); on CPU tensors they run the plain
  versions instead. A CUDA tensor never reaches a plain version.
- :func:`fused_nerf_mlp_reference` and
  :func:`fused_nerf_mlp_backward_reference` are the plain versions: the
  same functions from the same packed weights, with the kernels' casting.
- :func:`unpack_grads` maps the packed gradient layout to the param tree.

Numerics: ``float32`` is true f32 throughout, with exact sin/cos.
``bfloat16`` rounds the encode, the weights and each layer's input
activations to bf16 and accumulates in f32; the heads read the rounded
activations and return f32. The bf16 backward also rounds each layer's
output gradient to bf16 (after the ReLU mask) and accumulates weight,
bias and encode gradients in f32, as the JAX kernel does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.ops.kernels import _build

_XF, _DF = 10, 4            # encoding bands the kernel serves (points, dirs)
_ENC_X_RAW, _ENC_D_RAW = 3 + 6 * _XF, 3 + 6 * _DF   # 63, 27
_ENC_X, _ENC_D = 64, 32     # the kernel's padded encode rows
MAX_DEPTH = 16              # kMaxDepth in csrc/fused_mlp_common.cuh
MAX_WIDTH = 256             # kMaxWidth: widest trunk or view branch served
_ALIGN = 8                  # segment offsets: 16-byte aligned bf16 loads
_TILE = 64                  # kTile in csrc/fused_mlp_common.cuh
_TC_PIECE = 64              # kPiece in csrc/fused_mlp_tc.cu: tensor-core widths pad to it
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
    """Whether the kernels serve these dimensions: trunk and view widths up
    to ``MAX_WIDTH``, at most ``MAX_DEPTH`` dense layers."""
    return 1 <= width <= MAX_WIDTH and 1 <= v_width <= MAX_WIDTH and 1 <= depth <= MAX_DEPTH


def supports_arch(params) -> bool:
    """Whether the kernels serve a network (a NerfMLP or a param tree)."""
    width, v_width, depth, _ = infer_arch(params.tree() if hasattr(params, "tree") else params)
    return supports_dims(width, v_width, depth)


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
    int64 offset table in the order ``csrc/fused_mlp_common.cuh`` reads it.

    ``weights_t`` holds the transposed (ld, K) copy of every segment but
    the two heads, at ``layout_t``'s offsets (``csrc/fused_mlp_bwd.cu``):
    the backward kernel's input-gradient products read it.

    bf16 packs also hold ``weights_tc``, the tensor-core forward's own
    pack (``csrc/fused_mlp_tc.cu``), with ``layout_tc``, an offset table
    in ``layout``'s order (the same bias offsets). Its layer segments are
    tiled by :func:`tc_tile`: trunk and view widths pad to multiples of
    64, and so does the K of the layers that read the trunk; the encodes
    keep K = 64 and 32. Its two head segments are those of ``weights``.
    f32 packs hold ``None`` there.
    """

    weights: torch.Tensor
    biases: torch.Tensor
    segments: Dict[str, Tuple[int, int, int]]
    bias_slots: Dict[str, Tuple[int, int]]
    layout: np.ndarray
    weights_t: torch.Tensor
    layout_t: np.ndarray
    width: int
    v_width: int
    depth: int
    ldw: int
    ldv: int
    dtype: str
    weights_tc: Optional[torch.Tensor] = None
    layout_tc: Optional[np.ndarray] = None

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
    pieces, pieces_t = [], []
    offsets_t: Dict[str, int] = {}
    off = off_t = 0
    for name, m, rows, ld in mats:
        padded = torch.zeros((rows, ld), dtype=torch.float32, device=device)
        padded[:m.shape[0], :m.shape[1]] = m
        size = _round_up(rows * ld, _ALIGN)
        pieces.append(torch.nn.functional.pad(padded.reshape(-1), (0, size - rows * ld)))
        segments[name] = (off, rows, ld)
        off += size
        if name not in ("alpha", "rgb"):        # rows and ld are multiples of 8
            pieces_t.append(padded.t().reshape(-1))
            offsets_t[name] = off_t
            off_t += rows * ld
    weights = torch.cat(pieces).to(_DTYPES[dtype])
    weights_t = torch.cat(pieces_t).to(_DTYPES[dtype])

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
            [offsets.get(f"dense{i}", -1) for i in range(MAX_DEPTH)]
            + [offsets.get(f"dense{i}_enc", -1) for i in range(MAX_DEPTH)]
            + [offsets[n] for n in ("alpha", "bottleneck", "viewdirs", "viewdirs_dir", "rgb")]
            + [bias_slots[f"dense{i}"][0] if i < depth else -1 for i in range(MAX_DEPTH)]
            + [bias_slots[n][0] for n in ("alpha", "bottleneck", "viewdirs", "rgb")],
            dtype=np.int64)

    layout = table({name: off for name, (off, _, _) in segments.items()})
    layout_t = np.array(
        [offsets_t.get(f"dense{i}", -1) for i in range(MAX_DEPTH)]
        + [offsets_t.get(f"dense{i}_enc", -1) for i in range(MAX_DEPTH)]
        + [offsets_t[n] for n in ("bottleneck", "viewdirs", "viewdirs_dir")],
        dtype=np.int64)
    weights_tc = layout_tc = None
    if dtype == "bfloat16":
        ldw_tc, ldv_tc = _round_up(ldw, _TC_PIECE), _round_up(ldv, _TC_PIECE)
        offsets_tc: Dict[str, int] = {}
        pieces_tc = []
        off_tc = 0
        for (name, m, rows, ld), flat in zip(mats, pieces):
            if name in ("alpha", "rgb"):          # the heads run on the CUDA cores
                piece = flat
            else:
                encoded = name in ("dense0", "viewdirs_dir") or name.endswith("_enc")
                piece = tc_tile(m, rows if encoded else ldw_tc, ldw_tc if ld == ldw else ldv_tc)
            pieces_tc.append(piece)
            offsets_tc[name] = off_tc
            off_tc += piece.numel()
        weights_tc = torch.cat(pieces_tc).to(torch.bfloat16)
        layout_tc = table(offsets_tc)
    return PackedMLP(weights=weights, biases=biases, segments=segments,
                     bias_slots=bias_slots, layout=layout, weights_t=weights_t,
                     layout_t=layout_t, width=width, v_width=v_width, depth=depth,
                     ldw=ldw, ldv=ldv, dtype=dtype, weights_tc=weights_tc,
                     layout_tc=layout_tc)


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


def _trunk(mat, bias, enc_x: torch.Tensor, rnd, depth: int, skips):
    """Every trunk layer's output, as the kernels compute them."""
    hs = [rnd(torch.relu(enc_x @ mat("dense0") + bias("dense0")))]
    for i in range(1, depth):
        acc = hs[-1] @ mat(f"dense{i}")
        if f"dense{i}_enc" in skips:
            acc = acc + enc_x @ mat(f"dense{i}_enc")
        hs.append(rnd(torch.relu(acc + bias(f"dense{i}"))))
    return hs


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
    h = _trunk(mat, bias, enc_x, rnd, pk.depth, pk.segments)[-1]
    sigma = torch.relu(h @ mat("alpha") + bias("alpha"))[:, 0]
    if sigma_only:
        rgb = torch.zeros((pts.shape[0], 3), dtype=dt, device=pts.device)
    else:
        enc_d = rnd(_encode(dirs, d_freqs, _ENC_D))
        bneck = rnd(h @ mat("bottleneck") + bias("bottleneck"))
        hv = rnd(torch.relu(bneck @ mat("viewdirs") + enc_d @ mat("viewdirs_dir")
                            + bias("viewdirs")))
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
            bneck = rnd(h @ mat("bottleneck") + bias("bottleneck"))
            hv = rnd(torch.relu(bneck @ mat("viewdirs") + enc_d @ mat("viewdirs_dir")
                                + bias("viewdirs")))
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
    f32 packs launch the CUDA-core kernel (``csrc/fused_mlp.cu``), bf16
    packs the tensor-core kernel (``csrc/fused_mlp_tc.cu``, also counted
    in ``fused_nerf_mlp.tc_launches``)."""
    dirs, dir_div, batch, n = _kernel_inputs(pk, points, viewdirs)
    rgb = torch.empty((*batch, 3), dtype=torch.float32, device=points.device)
    sigma = torch.empty(batch, dtype=torch.float32, device=points.device)
    if n == 0:
        return rgb, sigma
    lib = _build.load_library()
    tc = pk.dtype == "bfloat16"
    entry, weights, layout = ((lib.nerf_fused_mlp_tc_forward, pk.weights_tc, pk.layout_tc) if tc
                              else (lib.nerf_fused_mlp_forward, pk.weights, pk.layout))
    err = entry(points.data_ptr(), dirs.data_ptr(), n, dir_div, weights.data_ptr(),
                pk.biases.data_ptr(), layout.ctypes.data, layout.size, pk.ldw, pk.ldv, pk.depth,
                int(sigma_only), rgb.data_ptr(), sigma.data_ptr(), points.device.index or 0,
                _stream(points.device))
    if err != 0:
        raise RuntimeError(f"fused MLP kernel launch failed with CUDA error {err}")
    fused_nerf_mlp.launches += 1
    fused_nerf_mlp.tc_launches += int(tc)
    return rgb, sigma


def fused_nerf_mlp_backward(params, points: torch.Tensor, viewdirs: torch.Tensor,
                            g_rgb: torch.Tensor, g_sigma: torch.Tensor, *, x_freqs: int = 10,
                            d_freqs: int = 4, dtype: str = "float32", sigma_only: bool = False,
                            input_grads: bool = True):
    """The backward kernel K2: the contract of
    :func:`fused_nerf_mlp_backward_reference`, which CPU tensors run.

    CUDA tensors launch K2 on the current stream without synchronizing,
    and count one launch per call in ``fused_nerf_mlp_backward.launches``
    (the kernel and its fixed-order sum of per-CTA partials). Two calls on
    the same inputs give bitwise-equal results.
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
        tiles = -(-n // _TILE)
        grid = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
        act = torch.empty(grid * pk.depth * pk.ldw * _TILE, dtype=torch.float32, device=dev)
        partials = torch.zeros(grid * (n_w + n_b), dtype=torch.float32, device=dev)
        err = _build.load_library().nerf_fused_mlp_backward(
            points.data_ptr(), dirs.data_ptr(), n, dir_div, g_rgb.data_ptr(),
            g_sigma.data_ptr(), pk.weights.data_ptr(), pk.weights_t.data_ptr(),
            pk.biases.data_ptr(), pk.layout.ctypes.data, pk.layout.size,
            pk.layout_t.ctypes.data, pk.layout_t.size, pk.ldw, pk.ldv, pk.depth,
            int(dtype == "bfloat16"), int(sigma_only), act.data_ptr(), partials.data_ptr(),
            n_w, n_b, grid, dweights.data_ptr(), dbiases.data_ptr(),
            dpts.data_ptr() if input_grads else None, ddirs.data_ptr() if input_grads else None,
            dev.index or 0, _stream(dev))
        if err != 0:
            raise RuntimeError(f"fused MLP backward kernel launch failed with CUDA error {err}")
        fused_nerf_mlp_backward.launches += 1
    if not input_grads:
        return dweights, dbiases, None, None
    return dweights, dbiases, dpts.view(*batch, 3), ddirs.view(*batch, 3)


fused_nerf_mlp_backward.launches = 0


class _FusedMLP(torch.autograd.Function):
    """The fused MLP with its backward, the counterpart of the JAX
    package's ``_make_op`` ``custom_vjp``. The inputs are points, viewdirs
    and the network's parameter tensors, which forward saves: changing one
    in place before backward raises, as autograd does. Forward and
    backward run the kernels on CUDA tensors and the plain versions on CPU
    tensors; points' and viewdirs' gradients are computed only when asked
    for."""

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
    without synchronizing; CPU tensors run the plain versions.
    """
    _check_call(x_freqs, d_freqs, dtype)
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_mlp takes CPU or CUDA tensors, got {points.device}")
    tree = params.tree() if hasattr(params, "tree") else params
    names = [(layer, part) for layer in tree for part in ("kernel", "bias")]
    opts = dict(x_freqs=x_freqs, d_freqs=d_freqs, dtype=dtype, sigma_only=sigma_only)
    return _FusedMLP.apply(params, opts, names, points, viewdirs,
                           *(tree[layer][part] for layer, part in names))


fused_nerf_mlp.launches = 0
fused_nerf_mlp.tc_launches = 0
