"""The fused CUDA MLP kernel vs the plain PyTorch oracle.

Runs both implementations on the same random batch and reports the max
deviation. On the card the kernel is K1 (``nerf_rs_tpu_torch/ops/kernels/
csrc/fused_mlp_f32tc.cu`` in float32, ``fused_mlp_tc.cu`` in bfloat16,
both on the tensor cores) and its time is measured and printed beside the
card's name and power limit; on the CPU (``--cpu``) the wrapper runs the
kernel's plain PyTorch version, on a small batch by default.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None, help="batch size (points)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --cpu to run on the CPU")
    device = torch.device("cpu" if args.cpu else "cuda")

    import numpy as np

    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params, nerf_mlp
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp
    from nerf_rs_tpu_torch.utils.profiling import device_label

    on_card = device.type == "cuda"
    n = args.n or (1 << 20 if on_card else 1 << 10)

    net = NerfMLP(init_nerf_params(torch.Generator(device).manual_seed(0)), device=device)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    with torch.no_grad():
        rgb_o, sig_o = nerf_mlp(net, pts, dirs)
        rgb_k, sig_k = fused_nerf_mlp(net, pts, dirs, dtype=args.dtype)
    print(f"max |rgb - oracle|   = {float((rgb_k - rgb_o).abs().max()):.2e}")
    print(f"max |sigma - oracle| = {float((sig_k - sig_o).abs().max()):.2e}")

    if on_card:
        with torch.no_grad():
            fused_nerf_mlp(net, pts, dirs, dtype=args.dtype)      # warm
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            reps = 10
            start.record()
            for _ in range(reps):
                fused_nerf_mlp(net, pts, dirs, dtype=args.dtype)
            end.record()
            torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
        # Two operations a weight a sample (1.187 MFLOP for the lego network;
        # the encode and the activations add a few hundred).
        flops = 2 * sum(int(p["kernel"].numel()) for p in net.tree().values()) * n
        print(f"{n} samples ({args.dtype}) in {dt * 1e3:.3f} ms = {n / dt / 1e6:.0f} M samples/s"
              f" ~ {flops / dt / 1e12:.1f} TFLOP/s on {device_label(device)}")


if __name__ == "__main__":
    main()
