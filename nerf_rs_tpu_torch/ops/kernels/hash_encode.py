"""Multiresolution hash encode: the CUDA kernel's wrapper, its plain
PyTorch version and the autograd function that joins them.

The kernel (``csrc/hash_encode.cu``) is the port's counterpart of the JAX
package's gather probe P1 (``tools/pallas_gather_probe.py:81``): the
table-row gather that the TPU could not run inside a kernel, fused here
with the spatial hash and the trilinear blend of
``nerf_rs_tpu/models/hashgrid.py::hash_encode``. Per sample and level:

- the point normalized into ``cfg.aabb``, NaN to 0 and +-inf to +-max
  (``nan_to_num``), clipped to [0, 1];
- per axis ``pos = N_l * x``, ``i0 = clip(floor(pos), 0, N_l - 1)``,
  ``frac = pos - i0``;
- per corner (``models.hashgrid._CORNERS`` order) the direct index
  ``(ix (N+1) + iy) (N+1) + iz`` where ``(N+1)^3 <= T``, else the xor of the
  uint32 products with the primes ``& (T - 1)``, plus the level offset
  ``l T``; the weight ``wx wy wz`` in f32;
- the corners' rows times their weights, summed in f32 in corner order,
  rounded once to the tables' dtype; output (..., L*F), point-major, then
  level, then feature.

:func:`hash_encode_reference` is that function in plain ops, on any device
and for any number of levels.
:func:`fused_hash_encode` is differentiable in the tables and the points:
on CUDA tensors its forward launches the kernel (counted in
``fused_hash_encode.launches``), on CPU tensors it runs the plain version;
it serves the tables of :func:`supported` and raises for others.
:func:`blocked_hash_encode` is the same function for any number of
levels: on CUDA tensors one launch a block of up to ``MAX_LEVELS`` levels,
each writing its columns of the output (``models.hashgrid.hash_encode``
calls it).
The backward is plain PyTorch on both devices, as the JAX package computes
it in XLA outside any Pallas kernel: it recomputes each corner's rows and
weights from the points (keeping them would cost about 1 KiB a sample at
L = 16) and accumulates d(tables) in f32, with ``index_put_(accumulate=True)``
(the sort-based, deterministic form of ``index_add_`` on the card) or, with
``cfg.grad_impl == "sorted"``, the JAX package's sort + cumsum-difference
segment sums; then casts to the tables' dtype. d(points) flows through the
trilinear weights, only when asked for.

torch has no uint32 product on the CPU: the hash is computed in int64,
whose low 32 bits are the uint32 products, then masked with ``T - 1``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.models.hashgrid import _CORNERS, _PRIMES, level_resolutions
from nerf_rs_tpu_torch.ops.kernels import _build

MAX_LEVELS = 64            # kMaxLevels in csrc/hash_encode.cu
MAX_TABLE = 1 << 32        # rows per level: T - 1 is a uint32 mask
_DTYPES = (torch.float32, torch.bfloat16)


def supported(tables: torch.Tensor) -> bool:
    """The tables the kernel serves: (L, T, F) f32 or bf16 with
    1 <= L <= MAX_LEVELS, 1 <= T <= 2^32 and F >= 1."""
    if tables.dim() != 3 or tables.dtype not in _DTYPES:
        return False
    levels, table_size, features = tables.shape
    return 1 <= levels <= MAX_LEVELS and 1 <= table_size <= MAX_TABLE and features >= 1


def level_constants(cfg, table_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per level: N_l (f32), N_l + 1 (int32) and whether the level indexes
    directly ((N_l + 1)^3 <= T), from :func:`level_resolutions`' Python
    integers."""
    res = np.asarray(level_resolutions(cfg), np.int64)
    direct = (res + 1) ** 3 <= table_size
    return res.astype(np.float32), (res + 1).astype(np.int32), direct.astype(np.int32)


def _normalized(points: torch.Tensor, cfg) -> torch.Tensor:
    """(N, 3) points in the AABB's unit cube before the clip."""
    lo, hi = cfg.aabb
    return (points.to(torch.float32).reshape(-1, 3) - lo) / (hi - lo)


def _lattice(points: torch.Tensor, cfg) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per axis, the cell's low corner (N, L) int64 and the fraction in it
    (N, L) f32."""
    res = level_resolutions(cfg)
    ns = torch.tensor(res, dtype=torch.float32, device=points.device)
    xs = torch.clamp(torch.nan_to_num(_normalized(points, cfg)), 0.0, 1.0)
    comps = []
    for a in range(3):
        pos = xs[:, a:a + 1] * ns                               # (N, L)
        i0 = torch.clamp(torch.floor(pos), min=torch.zeros_like(ns), max=ns - 1.0)
        comps.append((i0.to(torch.int64), pos - i0))
    return comps


class _Corners:
    """The flat table rows and trilinear weights of each corner, from the
    lattice of :func:`_lattice`."""

    def __init__(self, comps, cfg, table_size: int, device):
        self.comps = comps
        self.table_size = table_size
        _, np1, direct = level_constants(cfg, table_size)
        levels = len(np1)
        self.np1 = torch.as_tensor(np1.astype(np.int64), device=device)
        self.direct = torch.as_tensor(direct.astype(bool), device=device)
        self.offset = torch.arange(levels, dtype=torch.int64, device=device) * table_size

    def __call__(self, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
        bx, by, bz = (int(b) for b in _CORNERS[c])
        (ix, fx), (iy, fy), (iz, fz) = self.comps
        cx, cy, cz = ix + bx, iy + by, iz + bz
        d_idx = (cx * self.np1 + cy) * self.np1 + cz
        h = (cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])
        idx = torch.where(self.direct, d_idx, h & (self.table_size - 1)) + self.offset
        w = (fx if bx else 1.0 - fx) * (fy if by else 1.0 - fy) * (fz if bz else 1.0 - fz)
        return idx, w


def _check(tables: torch.Tensor, points: torch.Tensor, cfg) -> Tuple[int, int, int]:
    """The shapes every version takes; -> (L, T, F)."""
    if tables.dim() != 3:
        raise ValueError(f"tables must be (L, T, F), got {tuple(tables.shape)}")
    levels, table_size, features = tables.shape
    if levels != len(level_resolutions(cfg)):
        raise ValueError(f"tables have {levels} levels, config implies "
                         f"{len(level_resolutions(cfg))}")
    if points.shape[-1] != 3:
        raise ValueError(f"points must end in 3, got {tuple(points.shape)}")
    if tables.device != points.device:
        raise ValueError(f"tables on {tables.device}, points on {points.device}")
    return levels, table_size, features


def _check_kernel(tables: torch.Tensor, points: torch.Tensor, cfg,
                  blocked: bool = False) -> Tuple[int, int, int]:
    """:func:`_check`, and the kernel's envelope (:func:`supported`; with
    ``blocked`` any number of levels, in blocks of ``MAX_LEVELS``)."""
    dims = _check(tables, points, cfg)
    if not supported(tables[:MAX_LEVELS] if blocked else tables):
        raise NotImplementedError(
            f"the hash encode serves (L, T, F) f32 or bf16 tables with L <= {MAX_LEVELS} and "
            f"T <= 2^32; got {tuple(tables.shape)} {tables.dtype} (ROADMAP queue 1, item 12)")
    return dims


def hash_encode_reference(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: (L, T, F) tables
    and (..., 3) points -> (..., L*F) in the tables' dtype."""
    levels, table_size, features = _check(tables, points, cfg)
    batch = points.shape[:-1]
    flat = tables.reshape(levels * table_size, features)
    corners = _Corners(_lattice(points, cfg), cfg, table_size, points.device)
    acc = None
    for c in range(8):
        idx, w = corners(c)
        term = flat[idx].to(torch.float32) * w[..., None]         # (N, L, F)
        acc = term if acc is None else acc + term
    return acc.to(tables.dtype).reshape(*batch, levels * features)


def _launch(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    """The kernel on CUDA tensors, on the current stream, without
    synchronizing: one launch a block of up to ``MAX_LEVELS`` levels, each
    into its columns of the output."""
    levels, table_size, features = _check_kernel(tables, points, cfg, blocked=True)
    if not tables.is_contiguous():
        raise ValueError("tables must be contiguous")
    dev = points.device
    batch = points.shape[:-1]
    pts = points.to(torch.float32).reshape(-1, 3).contiguous()
    n = pts.shape[0]
    out = torch.empty((n, levels * features), dtype=tables.dtype, device=dev)
    if n == 0:
        return out.reshape(*batch, levels * features)
    res, np1, direct = level_constants(cfg, table_size)
    lo, hi = cfg.aabb
    bf16 = tables.dtype == torch.bfloat16
    lib = _build.load_library()
    for a in range(0, levels, MAX_LEVELS):
        b = min(levels, a + MAX_LEVELS)
        block = tables[a:b]
        dst = out if b - a == levels else torch.empty((n, (b - a) * features),
                                                     dtype=tables.dtype, device=dev)
        # The paired loads read aligned pairs of rows (16 bytes in f32, 8 in bf16).
        pair = (features == 2 and table_size % 2 == 0
                and block.data_ptr() % (8 if bf16 else 16) == 0)
        consts = [np.ascontiguousarray(c[a:b]) for c in (res, np1, direct)]
        err = lib.nerf_hash_encode(
            pts.data_ptr(), n, block.data_ptr(), b - a, table_size, features, int(bf16),
            int(pair), *(c.ctypes.data_as(ctypes.c_void_p) for c in consts), float(lo),
            float(hi - lo), dst.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"hash encode kernel launch failed with CUDA error {err}")
        fused_hash_encode.launches += 1
        if dst is not out:
            out[:, a * features:b * features] = dst
    return out.reshape(*batch, levels * features)


def _forward(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    if points.device.type == "cpu":
        return hash_encode_reference(tables, points, cfg)
    if points.device.type != "cuda":
        raise ValueError(f"the hash encode takes CPU or CUDA tensors, got {points.device}")
    return _launch(tables, points, cfg)


def _segment_sums(idx: torch.Tensor, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Sum of ``rows`` (M, F) f32 per table row, as the JAX package's sorted
    VJP computes it: a stable sort by index, an f32 cumsum, and each
    segment's total as the cumsum at its end less the cumsum before its
    start, written by two scatters of unique rows (``n_rows`` is the trash
    row of the non-ends)."""
    si, order = torch.sort(idx, stable=True)
    sg = rows[order]
    csum = torch.cumsum(sg, dim=0)
    change = si[1:] != si[:-1]
    true = torch.ones(1, dtype=torch.bool, device=idx.device)
    is_end, is_start = torch.cat([change, true]), torch.cat([true, change])
    trash = torch.full_like(si, n_rows)
    ends = torch.zeros((n_rows + 1, rows.shape[1]), dtype=torch.float32, device=idx.device)
    starts = torch.zeros_like(ends)
    ends[torch.where(is_end, si, trash)] = csum
    starts[torch.where(is_start, si, trash)] = csum - sg
    return (ends - starts)[:n_rows]


def _clip_factor(points: torch.Tensor, cfg) -> torch.Tensor:
    """d clip(nan_to_num(x)) / dx of the normalized points, as JAX's
    maximum / minimum give it: 1 inside (0, 1), 1/2 on its ends, 0 outside
    and where x is not finite."""
    xs = _normalized(points, cfg)
    inside = ((xs > 0.0) & (xs < 1.0)).to(torch.float32)
    ends = ((xs == 0.0) | (xs == 1.0)).to(torch.float32)
    return inside + 0.5 * ends


class _HashEncode(torch.autograd.Function):
    """The hash encode with its plain backward (module docstring)."""

    @staticmethod
    def forward(ctx, tables, points, cfg):
        enc = _forward(tables, points, cfg)
        ctx.save_for_backward(tables, points)
        ctx.cfg = cfg
        return enc

    @staticmethod
    def backward(ctx, g):
        tables, points = ctx.saved_tensors
        cfg = ctx.cfg
        want_tables, want_points = ctx.needs_input_grad[:2]
        levels, table_size, features = tables.shape
        n_rows = levels * table_size
        comps = _lattice(points, cfg)
        corners = _Corners(comps, cfg, table_size, points.device)
        g = g.reshape(-1, levels, features).to(torch.float32)
        d_tables = d_points = None
        if want_tables:
            d_flat = torch.zeros((n_rows, features), dtype=torch.float32, device=g.device)
            for c in range(8):
                idx, w = corners(c)
                idx, rows = idx.reshape(-1), (g * w[..., None]).reshape(-1, features)
                if cfg.grad_impl == "sorted":
                    d_flat += _segment_sums(idx, rows, n_rows)
                else:
                    d_flat.index_put_((idx,), rows, accumulate=True)
            d_tables = d_flat.to(tables.dtype).reshape(tables.shape)
        if want_points:
            flat = tables.detach().reshape(n_rows, features).to(torch.float32)
            fracs = [f for _, f in comps]
            d_frac = [torch.zeros_like(fracs[0]) for _ in range(3)]
            for c in range(8):
                idx, _ = corners(c)
                dw = torch.sum(g * flat[idx], dim=-1)                   # dL / dw_c, (N, L)
                bits = [int(b) for b in _CORNERS[c]]
                axis_w = [f if b else 1.0 - f for f, b in zip(fracs, bits)]
                for a in range(3):
                    others = axis_w[(a + 1) % 3] * axis_w[(a + 2) % 3]
                    d_frac[a] += dw * others if bits[a] else -(dw * others)
            ns = torch.tensor(level_resolutions(cfg), dtype=torch.float32, device=g.device)
            dxs = torch.stack([torch.sum(d * ns, dim=-1) for d in d_frac], dim=-1)   # (N, 3)
            lo, hi = cfg.aabb
            d_points = (dxs * _clip_factor(points, cfg) / (hi - lo)).reshape(points.shape)
            d_points = d_points.to(points.dtype)
        return d_tables, d_points, None


def fused_hash_encode(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    """(L, T, F) tables, (..., 3) points -> (..., L*F) in the tables' dtype,
    differentiable in both.

    CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run :func:`hash_encode_reference`. Tables
    outside :func:`supported` raise NotImplementedError on both devices.
    """
    _check_kernel(tables, points, cfg)
    return _HashEncode.apply(tables, points, cfg)


fused_hash_encode.launches = 0


def blocked_hash_encode(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`fused_hash_encode` for any number of levels: CUDA tensors
    launch the kernel once a block of up to ``MAX_LEVELS`` levels (each
    launch counted in ``fused_hash_encode.launches``), CPU tensors run
    :func:`hash_encode_reference`; the same backward. Tables the kernel
    cannot read (their dtype, T > 2^32) raise NotImplementedError."""
    _check_kernel(tables, points, cfg, blocked=True)
    return _HashEncode.apply(tables, points, cfg)
