"""How far K2 bf16 lies from the float64 evaluation on a 32-deep random
network, as the wide1k bf16 forward's promotion group changes (CPU).

K2 bf16 recomputes with K1 bf16's own code, so on a deep network its
distance from float64 is set mostly by the forward's bf16 roundings, which
depend on how the forward sums. The wide1k bf16 kernel
(nerf_rs_tpu_torch/ops/kernels/csrc/fused_mlp_wide1k_tc.cu) sums each
group of K rows with wgmma, whose accumulator rounds toward zero as it adds
a k-step of 16 products, and adds the group to a running f32 sum, rounded
to nearest. This tool runs K2's plain version with the forward's layer
sums replaced by that arithmetic (each k-step's 16 products summed in
float64, added to the group's sum and rounded toward zero; the groups
added in f32), for each group length given, and prints the largest
distance of any gradient from the float64 evaluation, beside the plain
version's (f32 sums) on this CPU. The backward's own products stay the
plain version's: varying them moved the distance by less than 1% here.

    python3 tools/torch_wide1k_bf16_groups.py --arch 1024,1024,32,10 --rows 16,32,64

The network and samples are tests/test_torch_cuda.py's random K2 case
(chip_smoke.random_k2_case: seed 5, 37 x 29 samples). Needs no card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm  # noqa: E402


def toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x64.to(torch.float32)
    over = f.double().abs() > x64.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def grouped_dense(rows: int):
    """fm._dense in the wide1k bf16 kernel's arithmetic with groups of
    ``rows`` K rows (float32 operands only; float64 calls stay exact)."""
    real = fm._dense

    def dense(sources, b):
        if sources[0][0].dtype != torch.float32:
            return real(sources, b)
        run = None
        for a, w in sources:
            a64, w64 = a.double(), w.double()
            for c in range(0, a.shape[1], rows):
                acc = None
                for s in range(c, min(c + rows, a.shape[1]), 16):
                    part = a64[:, s:s + 16] @ w64[s:s + 16]
                    acc = toward_zero(part) if acc is None else toward_zero(acc.double() + part)
                run = acc if run is None else run + acc
        return run + b

    return dense


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="1024,1024,32,10", help="width,v_width,depth,skip_at")
    ap.add_argument("--rows", default="16,32,64", help="promotion group lengths (K rows)")
    ap.add_argument("--sigma-only", action="store_true")
    args = ap.parse_args()
    arch = tuple(int(v) for v in args.arch.split(","))
    net, inputs = cs.random_k2_case(arch, torch.device("cpu"))
    pk = net.packed("bfloat16")
    kw = dict(dtype="bfloat16", sigma_only=args.sigma_only)
    plain = fm.fused_nerf_mlp_backward_reference(pk, *inputs, **kw)
    exact = fm.fused_nerf_mlp_backward_reference(pk, *(a.double() for a in inputs), **kw)
    g64, gp = cs.named_gradients(pk, exact), cs.named_gradients(pk, plain)

    def worst(g):
        far = {k: cs.rel_err(g[k].double(), g64[k]) for k in g64}
        key = max(far, key=far.get)
        return far[key], key

    d, key = worst(gp)
    print(f"{arch} {'sigma-only' if args.sigma_only else 'full'}, 37 x 29 samples: plain "
          f"(f32 sums) {d:.4e} from float64 at worst ({key})", flush=True)
    real = fm._dense
    for rows in (int(r) for r in args.rows.split(",")):
        t0 = time.perf_counter()
        fm._dense = grouped_dense(rows)
        try:
            got = fm.fused_nerf_mlp_backward_reference(pk, *inputs, **kw)
        finally:
            fm._dense = real
        gk = cs.named_gradients(pk, got)
        d, key = worst(gk)
        vs_plain = max(cs.rel_err(gk[k], gp[k]) for k in gp)
        print(f"groups of {rows} K rows: {d:.4e} from float64 at worst ({key}); "
              f"{vs_plain:.4e} from plain; {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
