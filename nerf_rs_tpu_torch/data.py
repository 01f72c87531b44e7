"""Training data: weight distillation from the pretrained networks, the
port of ``nerf_rs_tpu/data.py``'s ``DistillationDataset``.

With no image dataset, ground truth comes from rendering the pretrained
teacher networks at random viewpoints on a sphere around the scene. Every
draw follows the JAX package's key schedule, and ``ops.random`` reproduces
``jax.random``, so a batch equals the JAX package's batch for the same seed
and step up to float rounding. The nerf_synthetic ``BlenderDataset`` is
ROADMAP queue 1, item 10.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.models.mlp import as_module
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.render import render_rays


class DistillationDataset:
    """Ray batches whose targets are the teacher networks' renders at
    random upper-hemisphere viewpoints, on ``device``. ``teacher_params``
    is {"coarse", "fine"}, each a param tree or a NerfMLP."""

    def __init__(self, teacher_params, *, radius: float = 4.03, near: float = 2.0,
                 far: float = 6.0, cfg: Optional[RenderConfig] = None, seed: int = 0,
                 device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.params = {net: as_module(p, self.device) for net, p in teacher_params.items()}
        self.radius = radius
        self.near, self.far = near, far
        self.cfg = cfg or RenderConfig(n_coarse=64, n_fine=128)
        self.seed = seed

    def batches(self, batch_rays: int, seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        key = random.key(self.seed + seed, self.device)
        step = 0
        near = torch.tensor(self.near, dtype=torch.float32, device=self.device)
        far = torch.tensor(self.far, dtype=torch.float32, device=self.device)
        while True:
            origins, dirs, rgb = _distill_batch(
                self.params, random.fold_in(key, torch.tensor(step)), self.radius, near, far,
                batch_rays, self.cfg)
            yield {"origins": origins, "dirs": dirs, "rgb": rgb, "near": near, "far": far}
            step += 1


@torch.no_grad()
def _distill_batch(params, key: torch.Tensor, radius: float, near, far, batch: int,
                   cfg: RenderConfig):
    """Viewpoints and the teacher render of one batch: random
    upper-hemisphere positions looking at the origin, ray directions
    jittered within the field of view -> (origins, dirs, rgb), each (B, 3)."""
    ko, kr = random.split(key)
    k1, k2 = random.split(ko)
    v = random.normal(k1, (batch, 3))
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    origins = torch.cat([v[:, :2], v[:, 2:].abs()], dim=-1) * radius
    to_center = -origins / torch.linalg.norm(origins, dim=-1, keepdim=True)
    dirs = to_center + random.normal(k2, (batch, 3)) * 0.18
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rgb = render_rays(params["coarse"], params["fine"], origins, dirs, near, far, kr, cfg)
    return origins, dirs, rgb
