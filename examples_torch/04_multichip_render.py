"""Sharded render over a torch.distributed world == single-device render,
bitwise.

The reference scales with rayon threads on one host; here the rays are
data-parallel over the ranks of a ``torch.distributed`` world, one process
a device (``parallel/``): each rank renders its contiguous rows of the ray
axis and one all-gather assembles the frame. Every ray draws from its own
stream, keyed by its global index, so the frame is bitwise the
single-device frame however the rays are split.

Run with the flags alone and the script launches itself again under
torchrun (``python -m torch.distributed.run --standalone``) as a world on
this host: one rank a card under NCCL, or with ``--cpu`` two CPU processes
under gloo. Launched by torchrun itself
(``python -m torch.distributed.run --nproc-per-node N
examples_torch/04_multichip_render.py``), each process joins that world.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import subprocess
import sys

CPU_RANKS = 2


def rank_main(args, device) -> None:
    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel import make_mesh, multihost
    from nerf_rs_tpu_torch.parallel.render_sharded import render_image_sharded
    from nerf_rs_tpu_torch.render import render_image

    assets = find_lego_assets()
    if assets is None:
        raise SystemExit("pretrained lego assets not found "
                         "(set $NERF_RS_TPU_ASSETS)")
    multihost.initialize(device=device)
    try:
        mesh = make_mesh(device)
        camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
        pc = as_module(load_nerf_params(assets / "coarse"), mesh.device)
        pf = as_module(load_nerf_params(assets / "fine"), mesh.device)
        cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
        key = random.key(0, mesh.device)

        if mesh.rank == 0:
            print(f"world: {mesh.size} rank(s), one {device.type} device each "
                  f"({'gloo' if device.type == 'cpu' else 'nccl'})")
        sharded = render_image_sharded(pc, pf, camera, args.size, args.size, key, cfg,
                                       mesh=mesh).cpu().numpy()
        single = render_image(pc, pf, camera, args.size, args.size, key, cfg).cpu().numpy()
        same = np.array_equal(sharded, single)
        if mesh.rank == 0:
            print(f"sharded == single-device, bitwise: {same}")
        if not same:
            raise SystemExit(f"rank {mesh.rank}: the sharded frame differs from the "
                             "single-device frame")
    finally:
        multihost.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")
    if "RANK" in _os.environ:                     # a rank of a world: render
        rank_main(args, device)
        return 0
    ranks = CPU_RANKS if args.cpu else torch.cuda.device_count()
    return subprocess.call([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", str(ranks), _os.path.abspath(__file__),
                            *sys.argv[1:]])


if __name__ == "__main__":
    sys.exit(main())
