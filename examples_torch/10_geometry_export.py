"""Geometry export: pull a colored surface mesh out of the trained field.

The reference renders images only; production NeRF users also extract
geometry (previews, DCC import, collision proxies). This example sweeps
the fine network's density on a lattice (the same sweep that bakes
occupancy grids: on the card the fused kernel K1 in bfloat16,
sigma-only), extracts the iso-surface as a voxel-boundary mesh, bakes
vertex colors by querying the network along inward normals, and writes an
ASCII PLY any mesh tool can open.

Equivalent CLI: python -m nerf_rs_tpu_torch extract -o lego.ply --iso 10
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--iso", type=float, default=10.0)
    ap.add_argument("--extent", type=float, default=1.5)
    ap.add_argument("--out", default="/tmp/lego_mesh.ply")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.extract import extract_scene_mesh, save_ply, vertex_colors
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu_torch.models.mlp import as_module

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    trees, _ = load_scene_assets(assets)
    params = {net: as_module(tree, device) for net, tree in trees.items()}

    verts, faces = extract_scene_mesh(
        params["coarse"], params["fine"], resolution=args.resolution,
        aabb=(-args.extent, args.extent), iso=args.iso)
    colors = vertex_colors(params["fine"], verts, faces)
    save_ply(args.out, verts, faces, colors=colors)
    ext = verts.max(0) - verts.min(0)
    print(f"wrote {args.out}: {len(verts):,} vertices, {len(faces):,} "
          f"triangles, extent {np.round(ext, 2)} "
          f"(lattice {args.resolution}^3, iso {args.iso})")


if __name__ == "__main__":
    main()
