"""Self-launching multi-process distributed render demo.

Run with no arguments: the script relaunches itself under torchrun
(``python -m torch.distributed.run --standalone``) as worker processes,
one a device (the pattern of a real multi-host job), each joining a
``torch.distributed`` world through torchrun's variables
(``parallel.multihost.initialize``). Every process renders its rows of the
frame; the rows are gathered to rank 0, which checks the frame against its
own single-device render and writes the image. On the card the world is
one process a card under NCCL; with ``--cpu`` it is two CPU processes
under gloo.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import subprocess
import sys

CPU_PROCESSES = 2
SIZE = 64


def _device():
    import torch

    cpu = "--cpu" in sys.argv
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    return torch.device("cpu" if cpu else "cuda")


def launch() -> int:
    import torch

    device = _device()
    n = CPU_PROCESSES if device.type == "cpu" else torch.cuda.device_count()
    return subprocess.call([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", str(n), os.path.abspath(__file__), "--worker",
                            *(["--cpu"] if device.type == "cpu" else [])])


def worker() -> int:
    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import save_png
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import as_module
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel import make_mesh, multihost
    from nerf_rs_tpu_torch.render import render_image

    device = _device()
    multihost.initialize(device=device)
    try:
        mesh = make_mesh(device)
        print(f"[proc {mesh.rank}] {mesh.size} processes, one device each "
              f"({mesh.device}, {'gloo' if device.type == 'cpu' else 'nccl'})", flush=True)

        assets = find_lego_assets()
        if assets is None:
            raise SystemExit("pretrained lego assets not found "
                             "(set $NERF_RS_TPU_ASSETS)")
        camera = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
        pc = as_module(load_nerf_params(assets / "coarse"), mesh.device)
        pf = as_module(load_nerf_params(assets / "fine"), mesh.device)
        cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024)
        key = random.key(0, mesh.device)
        img = multihost.render_image_multihost(pc, pf, camera, SIZE, SIZE, key, cfg, mesh=mesh)
        if img is not None:   # rank 0 only
            img = img.cpu().numpy()
            single = render_image(pc, pf, camera, SIZE, SIZE, key, cfg).cpu().numpy()
            same = np.array_equal(img, single)
            print(f"[proc {mesh.rank}] multihost == single-device, bitwise: {same}")
            if not same:
                raise SystemExit("the multihost frame differs from the single-device frame")
            save_png("lego_multihost.png", img, SIZE, SIZE)
            print(f"[proc {mesh.rank}] wrote lego_multihost.png")
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(worker() if "--worker" in sys.argv else launch())
