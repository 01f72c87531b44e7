#!/usr/bin/env python3
"""What the data-parallel layer costs ``train`` in a world of 1 on one
card: the CLI's ``train`` run in this process, in turns, plain (no process
group) and with torchrun's variables set (a world of 1 under NCCL: every
step through one all-reduce, the stop request read one step late).

    python3 tools/torch_world1_train_ab.py [--rounds 10] [--steps 40]

Each round runs both, the side that runs first alternating. A run's time
is its steady step (``chip_smoke.steady_step_ms``: from the second logged
step to the last, read from the step lines' rays/s), at the CLI's train
defaults (4096 rays, 64+128, f32, distillation from the lego networks).
Prints every run, each side's median and quartiles, the card's name and
power limit, and how many rounds the world of 1 was the faster. Needs a
card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--log-every", type=int, default=10)
    args = parser.parse_args()

    import torch

    from chip_smoke import TRAIN_RAYS, cli_run, steady_step_ms, world_variables

    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    argv = ["train", "--device", "cuda", "--steps", str(args.steps), "--log-every",
            str(args.log_every)]
    cli_run(argv)                                   # warm-up: allocator, library handles
    runs = {False: [], True: []}
    for r in range(args.rounds):
        for grouped in ((False, True) if r % 2 == 0 else (True, False)):
            with world_variables(grouped):
                out = cli_run(argv)
            if grouped and "mesh: 1 rank(s) (nccl)" not in out:
                sys.exit(f"error: the run did not join a world of 1 under NCCL:\n{out}")
            runs[grouped].append(steady_step_ms(out, TRAIN_RAYS))
            print(f"round {r} {'world of 1' if grouped else 'plain     '} "
                  f"{runs[grouped][-1]:.2f} ms", flush=True)
    print(card)
    for grouped, name in ((False, "plain"), (True, "world of 1 under NCCL")):
        q1, med, q3 = statistics.quantiles(runs[grouped], n=4)
        print(f"{name}: steady step median {med:.2f} ms, quartiles {q1:.2f}-{q3:.2f} "
              f"({len(runs[grouped])} runs of {args.steps} steps)")
    wins = sum(g < p for p, g in zip(runs[False], runs[True]))
    print(f"the world of 1 faster in {wins} of {args.rounds} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
