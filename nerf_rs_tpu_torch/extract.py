"""Geometry extraction, the port of ``nerf_rs_tpu/extract.py``: the
density lattice of a trained field -> an iso-surface mesh, written as an
ASCII PLY.

:func:`extract_scene_mesh` sweeps the fine network's sigma at the cell
centers of a lattice (``accel.density_grid``, the sweep that bakes the
occupancy grid: on the card K1 bf16 sigma-only for the archs it serves) and
:func:`extract_voxel_mesh` emits, for every lattice edge where sigma
crosses ``iso`` between two adjacent cells, the boundary face between
them, placed at the linearly interpolated crossing along that axis (flat
regions land sub-cell accurately; corners stay voxel-quantized, a trade
against marching cubes' 256-case tables). Vertices are deduplicated on
exact coordinates; faces are triangle pairs wound outward (occupied ->
empty). :func:`vertex_colors` bakes the fine network's colour, looked at
along the inward normal, through the plain f32 MLP.

The mesh assembly is numpy on the host, the JAX package's code copied
(this package imports nothing of it), so a lattice gives the same
vertices, faces and PLY bytes in both packages.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def extract_voxel_mesh(sigma: np.ndarray, iso: float,
                       aabb: Tuple[float, float] = (-2.0, 2.0)):
    """(R, R, R) density lattice -> (vertices (V, 3) f32, faces (F, 3) i32).

    Faces sit between cell centers where ``sigma`` crosses ``iso`` along an
    axis, at the interpolated crossing position; each quad becomes two
    triangles wound so normals point from the occupied side to the empty
    side. Returns empty arrays when nothing crosses the iso level.
    """
    sigma = np.asarray(sigma, np.float32)
    r = sigma.shape[0]
    assert sigma.shape == (r, r, r), sigma.shape
    lo, hi = float(aabb[0]), float(aabb[1])
    cell = (hi - lo) / r
    centers = lo + (np.arange(r, dtype=np.float32) + 0.5) * cell

    inside = sigma > iso
    quads = []       # (N, 4, 3) corner positions, outward-wound

    for axis in range(3):
        a = np.take(inside, np.arange(r - 1), axis=axis)
        b = np.take(inside, np.arange(1, r), axis=axis)
        cross = a != b
        idx = np.argwhere(cross)                       # (N, 3) lower-cell ijk
        if idx.size == 0:
            continue
        s0 = sigma[tuple((idx + 0).T)]
        off = np.zeros((1, 3), np.int64)
        off[0, axis] = 1
        s1 = sigma[tuple((idx + off).T)]
        # Interpolated crossing between the two cell centers along `axis`.
        t = np.clip((iso - s0) / np.where(np.abs(s1 - s0) < 1e-12,
                                          1e-12, s1 - s0), 0.0, 1.0)
        pos_axis = centers[idx[:, axis]] + t.astype(np.float32) * cell

        # (axis, u, v) must be an EVEN permutation of (0,1,2) so the CCW
        # corner winding's normal (u x v) points along +axis; the naive
        # sorted pair flips axis=1 (x cross z = -y).
        u_axis, v_axis = ((1, 2), (2, 0), (0, 1))[axis]
        cu = centers[idx[:, u_axis]]
        cv = centers[idx[:, v_axis]]
        h = np.float32(0.5 * cell)
        corners = np.empty((idx.shape[0], 4, 3), np.float32)
        for ci, (du, dv) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
            corners[:, ci, axis] = pos_axis
            corners[:, ci, u_axis] = cu + du * h
            corners[:, ci, v_axis] = cv + dv * h
        # Wind outward: flip when the OCCUPIED side is the upper cell.
        flip = s1 > s0
        corners[flip] = corners[flip, ::-1]
        quads.append(corners)

    if not quads:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    corners = np.concatenate(quads, axis=0)            # (Q, 4, 3)

    flat = corners.reshape(-1, 3)
    verts, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
    quad_idx = inv.reshape(-1, 4).astype(np.int32)
    faces = np.concatenate(
        [quad_idx[:, [0, 1, 2]], quad_idx[:, [0, 2, 3]]], axis=0)
    return verts.astype(np.float32), faces


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted average of adjacent face normals, unit length."""
    tri = vertices[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])  # 2x area
    n = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(n, faces[:, c], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def vertex_colors(params_fine, vertices: np.ndarray, faces: np.ndarray,
                  device=None) -> np.ndarray:
    """(V, 3) float colors: the fine network (a param tree or a module)
    queried at each vertex with the view direction along the inward normal
    (an outside observer facing the surface), through the plain MLP
    ``models.mlp.nerf_mlp`` in f32 on ``device`` (default: the params'
    device; the card for a tree of numpy arrays), clipped to [0, 1]."""
    from nerf_rs_tpu_torch.accel import _params_device
    from nerf_rs_tpu_torch.models.mlp import as_module, nerf_mlp

    device = torch.device(device) if device is not None else _params_device(params_fine)
    dirs = -vertex_normals(vertices, faces)
    with torch.no_grad():
        rgb, _ = nerf_mlp(as_module(params_fine, device),
                          torch.as_tensor(np.asarray(vertices, np.float32), device=device),
                          torch.as_tensor(np.asarray(dirs, np.float32), device=device))
    return np.clip(rgb.cpu().numpy(), 0.0, 1.0)


def save_ply(path: os.PathLike, vertices: np.ndarray,
             faces: np.ndarray, colors: np.ndarray = None) -> None:
    """ASCII PLY writer (no external mesh deps in this environment).
    ``colors``: optional (V, 3) floats in [0, 1] -> uchar r/g/b."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            c8 = (np.clip(np.asarray(colors), 0, 1) * 255.0 + 0.5).astype(np.uint8)
            np.savetxt(f, np.column_stack([vertices, c8]),
                       fmt="%.6f %.6f %.6f %d %d %d")
        else:
            np.savetxt(f, vertices, fmt="%.6f")
        np.savetxt(f, np.concatenate(
            [np.full((len(faces), 1), 3, np.int64), faces], axis=1), fmt="%d")


def load_ply(path: os.PathLike):
    """Minimal ASCII PLY reader (round-trip checks / tests)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n_v = n_f = 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n_v = int(line.split()[-1])
        elif line.startswith("element face"):
            n_f = int(line.split()[-1])
        elif line == "end_header":
            body = i + 1
            break
    verts = np.array([[float(v) for v in l.split()[:3]]
                      for l in lines[body:body + n_v]], np.float32)
    faces = np.array([[int(v) for v in l.split()[1:]]
                      for l in lines[body + n_v:body + n_v + n_f]], np.int32)
    return verts.reshape(-1, 3) if n_v else np.zeros((0, 3), np.float32), \
        faces.reshape(-1, 3) if n_f else np.zeros((0, 3), np.int32)


def extract_scene_mesh(params_coarse, params_fine, *, resolution: int = 128,
                       aabb: Tuple[float, float] = (-2.0, 2.0), iso: float = 10.0,
                       chunk: int = 262_144, device=None):
    """Trained networks -> the surface mesh of the FINE field (the
    render's geometry; the coarse network only guides sampling), from its
    ``accel.density_grid`` lattice on ``device`` (default: the params'
    device; the card for a tree of numpy arrays) -> (vertices (V, 3) f32, faces (F, 3) i32).

    ``iso`` is the density treated as the surface: with the render's
    sample spacing of about 0.03, exp(-10 * 0.03) marks about 26% opacity
    a sample, a solid surface on lego-scale scenes (CLI ``--iso``)."""
    from nerf_rs_tpu_torch.accel import density_grid

    sigma = density_grid(params_fine, resolution=resolution, aabb=aabb, chunk=chunk,
                         device=device).cpu().numpy()
    return extract_voxel_mesh(sigma, iso, aabb=aabb)
