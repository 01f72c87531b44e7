"""Training data, the port of ``nerf_rs_tpu/data.py``: nerf_synthetic
(blender) scenes and weight distillation from the pretrained networks.

* :class:`BlenderDataset` reads the standard nerf_synthetic layout
  (``transforms_{split}.json`` and PNGs), the format the lego weights were
  trained on. ``transform_matrix`` is camera-to-world with -z forward and y
  up; the field of view comes from ``camera_angle_x``. Its rays and the
  batches it draws equal the JAX package's: origins and colours bitwise,
  directions up to float rounding.
* :class:`DistillationDataset`: with no images, ground truth comes from
  rendering the pretrained teacher networks at random viewpoints on a
  sphere around the scene. Every draw follows the JAX package's key
  schedule, and ``ops.random`` reproduces ``jax.random``, so a batch
  equals the JAX package's batch for the same seed and step up to float
  rounding.

Both yield ray batches {origins, dirs, rgb, near, far} for
``train.train_step``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.io.image import load_png
from nerf_rs_tpu_torch.models.mlp import as_module
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.rays import Camera, camera_rays
from nerf_rs_tpu_torch.render import render_rays


def resolve_device(device) -> torch.device:
    """``device``, or the CUDA card when it is None: the datasets default
    to the card, as every entry point of the port does."""
    return torch.device(device) if device is not None else torch.device("cuda")


class BlenderDataset:
    """A nerf_synthetic scene: images and per-frame cameras -> ray batches.

    Every ray stays in host memory, as flat numpy arrays: one origin a
    frame (a pinhole camera has one) and a frame index a ray, the unit
    directions and the colours (RGBA composited onto white, or black).
    :meth:`batches` moves each batch to ``device`` (default: the CUDA
    card) as it draws it."""

    def __init__(self, root, split: str = "train", white_background: bool = True,
                 near: float = 2.0, far: float = 6.0, device=None):
        root = Path(root)
        self.device = resolve_device(device)
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        angle_x = float(meta["camera_angle_x"])
        origins, dirs, rgbs = [], [], []
        for frame in meta["frames"]:
            img_path = root / (frame["file_path"] + ".png")
            if not img_path.exists():
                img_path = root / frame["file_path"]
            rgba = load_png(img_path).astype(np.float32) / 255.0
            if rgba.shape[-1] == 4:
                rgb, a = rgba[..., :3], rgba[..., 3:]
                rgb = rgb * a + (1.0 - a) if white_background else rgb * a
            else:
                rgb = rgba[..., :3]
            m = np.asarray(frame["transform_matrix"], np.float32)
            h, w = rgb.shape[:2]
            focal = 0.5 * w / np.tan(0.5 * angle_x)
            cam = Camera(position=m[:3, 3], forward=(-m[:3, 2]).astype(np.float32),
                         up=m[:3, 1].astype(np.float32),
                         alpha_width=np.float32(np.arctan(0.5 * w / focal)),
                         alpha_height=np.float32(np.arctan(0.5 * h / focal)),
                         near=np.float32(near), far=np.float32(far))
            # The directions are computed on the device (a frame of
            # nerf_synthetic is 640 000 rays) and kept on the host.
            _, d = camera_rays(cam, h, w, self.device)
            origins.append(np.asarray(m[:3, 3], np.float32))
            dirs.append(d.reshape(-1, 3).cpu().numpy())
            rgbs.append(rgb.reshape(-1, 3))
        self.height, self.width = h, w
        self.frame_origins = np.stack(origins)
        self.dirs = np.concatenate(dirs)
        self.rgb = np.concatenate(rgbs)
        self.frame_idx = np.repeat(np.arange(len(origins), dtype=np.int32), h * w)
        self.near = float(near)
        self.far = float(far)

    def __len__(self):
        return self.rgb.shape[0]

    def batches(self, batch_rays: int, seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches of ``batch_rays`` rays drawn uniformly with
        replacement, the indices from ``np.random.default_rng(seed)`` as the
        JAX package draws them.

        For a CUDA device each batch is gathered into pinned host memory
        and copied with ``non_blocking=True``, so drawing it does not wait
        for the steps still queued on the card; the caching host allocator
        keeps a pinned buffer from reuse until its copy has finished."""
        rng = np.random.default_rng(seed)
        n = len(self)
        pin = self.device.type == "cuda"
        near = torch.tensor(self.near, dtype=torch.float32, device=self.device)
        far = torch.tensor(self.far, dtype=torch.float32, device=self.device)
        frame_origins, frame_idx, dirs, rgb = (torch.from_numpy(a) for a in (
            self.frame_origins, self.frame_idx, self.dirs, self.rgb))

        def gather(src, index):
            out = torch.empty((index.shape[0], *src.shape[1:]), dtype=src.dtype, pin_memory=pin)
            torch.index_select(src, 0, index, out=out)
            return out.to(self.device, non_blocking=True)

        while True:
            idx = torch.from_numpy(rng.integers(0, n, size=batch_rays))
            yield {"origins": gather(frame_origins, frame_idx[idx].long()),
                   "dirs": gather(dirs, idx), "rgb": gather(rgb, idx), "near": near, "far": far}


class DistillationDataset:
    """Ray batches whose targets are the teacher networks' renders at
    random upper-hemisphere viewpoints, on ``device`` (default: the CUDA
    card). ``teacher_params`` is {"coarse", "fine"}, each a param tree or a
    NerfMLP."""

    def __init__(self, teacher_params, *, radius: float = 4.03, near: float = 2.0,
                 far: float = 6.0, cfg: Optional[RenderConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
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
