#!/usr/bin/env python3
"""The CLI's ``train`` of a 512-wide student, this checkout against another
one and against the plain MLP, in turns: what the wide kernels change end
to end.

    python3 tools/torch_train_ab.py --parent DIR [--rounds 1] [--steps 16]

``DIR`` is another checkout of the repo (for example the parent commit,
unpacked with ``git archive <rev>`` into a gitignored directory such as
``scratch_checkout/``). Each run is ``python -m nerf_rs_tpu_torch train
--device cuda --width 512 --v-width 256 --steps N --log-every 3`` in its
own process, from the root of its checkout (which builds that checkout's
kernels at first use), at the CLI's other train defaults (4096 rays,
64 + 128 samples, distillation from the lego networks), in f32 and with
``--dtype bfloat16``. A run's time is its steady step
(``chip_smoke.steady_step_ms``: from the second logged step to the last,
read from the step lines' rays/s). A third side, "plain", is this
checkout with ``--impl xla`` (the plain MLP, cuBLAS products and autograd).
Per dtype: one warm-up run a side, then parent, change, plain, plain,
change, parent, ``--rounds`` times. Prints every run, whether it printed
a note (a checkout whose kernels do not serve the student trains it on
the plain MLP, with a note), each side's median, the ratios to the
parent and to plain, and the card's name and power limit. Needs one card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def run(root: Path, argv) -> str:
    """``python -m nerf_rs_tpu_torch`` with ``argv`` from ``root``: its
    output; a non-zero exit stops the tool."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-m", "nerf_rs_tpu_torch", *argv], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"error: {root}: train exited with {proc.returncode}:\n"
                 f"{(proc.stdout + proc.stderr)[-3000:]}")
    return proc.stdout


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True, help="another checkout's root")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--steps", type=int, default=16)
    args = parser.parse_args()

    from chip_smoke import TRAIN_RAYS, steady_step_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    if card.returncode != 0:
        sys.exit("error: needs a CUDA card (nvidia-smi failed)")
    card = card.stdout.strip().splitlines()[0]
    sides = {"parent": args.parent.resolve(), "change": REPO, "plain": REPO}
    for dtype in ("float32", "bfloat16"):
        argv = ["train", "--device", "cuda", "--width", "512", "--v-width", "256", "--steps",
                str(args.steps), "--log-every", "3"]
        if dtype == "bfloat16":
            argv += ["--dtype", "bfloat16"]

        def run_side(side):
            return run(sides[side], argv + (["--impl", "xla"] if side == "plain" else []))

        for side in sides:
            out = run_side(side)
            print(f"{dtype} {side} warm-up {steady_step_ms(out, TRAIN_RAYS):.2f} ms; note printed: "
                  f"{'note:' in out}", flush=True)
        times = {side: [] for side in sides}
        for r in range(args.rounds):
            for side in ("parent", "change", "plain", "plain", "change", "parent"):
                out = run_side(side)
                times[side].append(steady_step_ms(out, TRAIN_RAYS))
                print(f"{dtype} round {r} {side} {times[side][-1]:.2f} ms; note printed: "
                      f"{'note:' in out}", flush=True)
        med = {side: statistics.median(v) for side, v in times.items()}
        spread = {side: f"{min(v):.2f}-{max(v):.2f}" for side, v in times.items()}
        print(f"{card}: train --width 512 --v-width 256 {dtype}, 4096 rays 64+128, steady step "
              f"in turns (parent, change, plain, plain, change, parent) x {args.rounds}: parent "
              f"median {med['parent']:.2f} ms ({spread['parent']}), change {med['change']:.2f} "
              f"ms ({spread['change']}), plain MLP {med['plain']:.2f} ms ({spread['plain']}); "
              f"change / parent {med['change'] / med['parent']:.4f}, change / plain "
              f"{med['change'] / med['plain']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
