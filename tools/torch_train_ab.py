#!/usr/bin/env python3
"""The CLI's ``train`` of a 512-wide student, this checkout against another
one, in turns: what the wide kernels change end to end.

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
read from the step lines' rays/s). Per dtype: one warm-up run a side,
then parent, change, change, parent, ``--rounds`` times. Prints every
run, whether it printed a note (the parent trains a 512-wide student on
the plain MLP, with a note), each side's median, their ratio, and the
card's name and power limit. Needs one card.
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
    sides = {"parent": args.parent.resolve(), "change": REPO}
    for dtype in ("float32", "bfloat16"):
        argv = ["train", "--device", "cuda", "--width", "512", "--v-width", "256", "--steps",
                str(args.steps), "--log-every", "3"]
        if dtype == "bfloat16":
            argv += ["--dtype", "bfloat16"]
        for side, root in sides.items():
            out = run(root, argv)
            print(f"{dtype} {side} warm-up {steady_step_ms(out, TRAIN_RAYS):.2f} ms; note printed: "
                  f"{'note:' in out}", flush=True)
        times = {side: [] for side in sides}
        for r in range(args.rounds):
            for side in ("parent", "change", "change", "parent"):
                out = run(sides[side], argv)
                times[side].append(steady_step_ms(out, TRAIN_RAYS))
                print(f"{dtype} round {r} {side} {times[side][-1]:.2f} ms; note printed: "
                      f"{'note:' in out}", flush=True)
        p, c = (statistics.median(times[side]) for side in ("parent", "change"))
        print(f"{card}: train --width 512 --v-width 256 {dtype}, 4096 rays 64+128, steady step "
              f"in turns (parent, change, change, parent) x {args.rounds}: parent median "
              f"{p:.2f} ms ({min(times['parent']):.2f}-{max(times['parent']):.2f}), change median "
              f"{c:.2f} ms ({min(times['change']):.2f}-{max(times['change']):.2f}); change / "
              f"parent {c / p:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
