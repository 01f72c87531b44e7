#!/usr/bin/env python3
"""Wide K1 bf16's witness against float64, with the checkout's kernels and,
with ``--parent DIR``, with another version's: on each call, the sigma
counts that ``fused_mlp.bf16_sigma_agrees`` holds (samples outside the
bf16 bars, 2e-2 + 2e-2 |sigma|: kernel against plain, kernel against the
float64 evaluation, plain against float64) and the largest rgb distance
from plain, then the sums over the calls.

    python3 tools/torch_wide_bf16_witness.py [--parent DIR]

Calls (``chip_smoke.main_path_inputs``: the 256x256 frame's centre rays,
8192 x 64 coarse sigma-only, 8192 x 192 fine full): the lego networks
widened to 512/256/8 and 384/192/8 (``chip_smoke.widen_nerf``), phase 29
(b)'s random networks (``chip_smoke.WIDE_RANDOM``, seed 29) and the card
test's random 512/512/32 network (``chip_smoke.random_k2_case``), each
sigma-only at the coarse points and full at the fine ones. ``DIR`` holds
another version of ``csrc/``, e.g. the parent commit's from ``git archive
<rev> nerf_rs_tpu_torch/ops/kernels/csrc`` unpacked into a gitignored
directory such as ``scratch_checkout/``; it is built as
``tools/torch_k1_parent_ab.py`` builds it. Prints the card's name and
power limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def tool(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another version's csrc/ (its *.cu and headers)")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        bf16_sigma_agrees,
        fused_nerf_mlp,
        fused_nerf_mlp_reference,
    )

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))
    pts_c, pts_f, vd = cs.main_path_inputs(cam, dev)
    nets = {}
    for arch in ((512, 256, 8), (384, 192, 8)):
        for name in ("coarse", "fine"):
            tree = cs.widen_nerf(load_nerf_params(assets / name), *arch)
            nets[f"lego {name} {arch}"] = NerfMLP(tree, device=dev)
    for arch in cs.WIDE_RANDOM:
        g = torch.Generator(device=dev).manual_seed(29)
        nets[f"random {arch[:3]}"] = NerfMLP(init_nerf_params(g, ArchConfig(*arch)), device=dev)
    nets[f"random {cs.WIDE_K2_RANDOM[:3]} (card test)"] = cs.random_k2_case(cs.WIDE_K2_RANDOM,
                                                                            dev)[0]
    calls = []
    for label, net in nets.items():
        for pts, so in ((pts_c, True), (pts_f, False)):
            if "lego coarse" in label and not so or "lego fine" in label and so:
                continue
            calls.append((label, net, pts, so))
    with torch.no_grad():
        plain = [fused_nerf_mlp_reference(net, pts, vd, dtype="bfloat16", sigma_only=so)
                 for _, net, pts, so in calls]
        exact = [fused_nerf_mlp_reference(net, pts.double(), vd.double(), dtype="bfloat16",
                                          sigma_only=so)[1]
                 for _, net, pts, so in calls]
    ab = tool("torch_k1_parent_ab")
    sides = [("change", None)]
    if args.parent is not None:
        sides.append(("parent", ab.build_other(args.parent,
                                               Path(tempfile.mkdtemp(prefix="witness_")))[0]))
    totals = {}
    for side, lib in sides:
        sums = [0, 0, 0]
        with ab.launching(lib), torch.no_grad():
            for (label, net, pts, so), p, e in zip(calls, plain, exact):
                k = fused_nerf_mlp(net, pts, vd, dtype="bfloat16", sigma_only=so)
                torch.cuda.synchronize()
                ok, counts = bf16_sigma_agrees(k[1], p[1], e)
                c = (counts["kernel_vs_plain"], counts["kernel_vs_exact"], counts["plain_vs_exact"])
                sums = [a + b for a, b in zip(sums, c)]
                rgb = float((k[0] - p[0]).abs().max())
                print(f"{card}: {side} {label} {tuple(pts.shape[:-1])} "
                      f"{'sigma-only' if so else 'full'}: sigma outside the bf16 bars: kernel vs "
                      f"plain {c[0]}, kernel vs float64 {c[1]}, plain vs float64 {c[2]} (witness "
                      f"{'ok' if ok else 'missed'}); max |rgb - plain| {rgb:.3g}", flush=True)
        totals[side] = sums
    for side, (kp, ke, pe) in totals.items():
        print(f"{card}: {side}, over {len(calls)} calls: kernel vs plain {kp}, kernel vs float64 "
              f"{ke}, plain vs float64 {pe}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
