#!/usr/bin/env python3
"""How far two float32 training runs of the same job drift apart, on the
CPU: the JAX package on one device, the JAX package on 8 virtual devices
(the same ops, the rays' gradients summed in another order) and the port,
from the same 8x256 weights on the same batches and keys.

    python3 tools/torch_train_drift.py [--steps 4] [--scene DIR]

The job is ``tests/test_torch_cli.py``'s: the 2-frame 8x8 nerf_synthetic
scene of ``tests/test_torch_data.py`` (written to a temporary directory
unless ``--scene`` names one), 64 rays, 4 + 8 samples, ``impl="xla"``,
JAX-initialized weights. Prints,
after each step, each pair's loss difference (relative) and, per network,
the largest parameter difference and the share of entries more than 1e-5
apart. Needs JAX and the port; no card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--scene", help="nerf_synthetic scene (default: the tests' 2-frame one)")
    args = parser.parse_args()

    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    from test_torch_data import write_scene

    from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
    from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
    from nerf_rs_tpu.data import BlenderDataset
    from nerf_rs_tpu.models.mlp import init_nerf_params
    from nerf_rs_tpu.parallel.mesh import replicate
    from nerf_rs_tpu.parallel.train_sharded import create_sharded_train_state, sharded_train_step
    from nerf_rs_tpu.train import create_train_state, make_optimizer, train_step
    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_state_from_numpy
    from nerf_rs_tpu_torch.train import train_step as port_train_step

    scene = Path(args.scene) if args.scene else write_scene(Path(tempfile.mkdtemp()))
    jcfg = JaxTrainConfig(batch_rays=64, render=JaxRenderConfig(n_coarse=4, n_fine=8,
                                                               ray_chunk=64, impl="xla"))
    pcfg = TrainConfig(batch_rays=64, render=RenderConfig(n_coarse=4, n_fine=8, ray_chunk=64,
                                                          impl="xla"))
    params = {"coarse": init_nerf_params(jax.random.key(0)),
              "fine": init_nerf_params(jax.random.key(1))}
    one = create_train_state(jax.random.key(0), jcfg)._replace(
        params=params, opt_state=make_optimizer(jcfg).init(params))
    to_np = lambda tree: jax.tree_util.tree_map(np.array, tree)  # noqa: E731
    mesh, _ = create_sharded_train_state(jax.random.key(0), jcfg)
    eight = replicate(mesh, to_np(one))
    adam = one.opt_state[0]
    port = train_state_from_numpy(to_np(params), to_np(adam.mu), to_np(adam.nu), 0, 0, "cpu")
    batches = BlenderDataset(scene, device="cpu").batches(64, seed=0)
    key, port_key = jax.random.key(1), random.key(1, "cpu")

    def apart(a, get):
        out = []
        for net, tree in a.items():
            worst, over, total = 0.0, 0, 0
            for layer, parts in tree.items():
                for part, w in parts.items():
                    d = np.abs(get(net, layer, part) - np.asarray(w))
                    worst, over, total = max(worst, float(d.max())), over + int((d > 1e-5).sum()), \
                        total + d.size
            out.append(f"{net} max {worst:.3e}, > 1e-5 {over / total:.4%}")
        return "; ".join(out)

    for step in range(args.steps):
        batch = next(batches)
        k = jax.random.fold_in(key, step)
        one, m1 = train_step(one, batch, k, jcfg)
        eight, m8 = sharded_train_step(mesh, eight, batch, k, jcfg)
        port, mp = port_train_step(port, {n: torch.as_tensor(np.asarray(v)) for n, v in
                                          batch.items()},
                                   random.fold_in(port_key, torch.tensor(step)), pcfg)
        l1, l8, lp = (float(m["loss"]) for m in (m1, m8, mp))
        print(f"step {step}: loss JAX 1 device {l1:.8f}, 8 devices {l8:.8f}, port {lp:.8f}; "
              f"relative: 1 vs 8 {abs(l8 / l1 - 1):.2e}, port vs 8 {abs(lp / l8 - 1):.2e}")
        print("  params, JAX 1 vs 8 devices: "
              + apart(one.params, lambda n, lay, p: np.asarray(eight.params[n][lay][p])))
        print("  params, port vs JAX 8 devices: "
              + apart(eight.params, lambda n, lay, p: port.params[n].weights[f"{lay}_{p}"]
                      .detach().numpy()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
