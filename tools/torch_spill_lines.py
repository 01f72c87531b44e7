#!/usr/bin/env python3
"""Where a kernel source spills: compiles one ``csrc/`` source for sm_90a
with line info, disassembles it (``nvdisasm -g``) and counts the local
stores and loads (STL, LDL: register spills and local arrays) of each
kernel instance by the source line they carry.

    python3 tools/torch_spill_lines.py [SOURCE] [--top N]

SOURCE defaults to ``fused_mlp_wide_bwd_bf16.cu``. Prints, per instance,
its totals and its top N (default 25) lines as ``file:line count``. The
line is the innermost one of an inlined call. Needs nvcc and nvdisasm
(the CUDA toolkit); runs without a card.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", nargs="?", default="fused_mlp_wide_bwd_bf16.cu")
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory(prefix="spill_lines_") as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-cubin",
                        "-o", str(cubin), str(_build.CSRC / args.source)], check=True)
        sass = subprocess.run([str(Path(nvcc).with_name("nvdisasm")), "-g", "-c", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    fn = line = None
    for text in sass.splitlines():
        head = re.match(r"\s*\.text\.(\S+):", text)
        if head:
            fn = head.group(1)
            continue
        loc = re.search(r'File "(.*?)", line (\d+)', text)
        if loc and "inlined at" not in text:
            line = f"{Path(loc.group(1)).name}:{loc.group(2)}"
        op = re.search(r"\b(STL|LDL)\b", text)
        if op and fn:
            counts[fn][(op.group(1), line)] += 1
    if not counts:
        print(f"{args.source}: no local loads or stores")
    for fn, by_line in counts.items():
        total = collections.Counter()
        for (op, _), c in by_line.items():
            total[op] += c
        print(f"{fn[:120]}: STL {total['STL']}, LDL {total['LDL']} (instructions)")
        for (op, where), c in by_line.most_common(args.top):
            print(f"    {op} {where} {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
