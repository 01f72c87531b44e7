"""Pinhole camera and vectorized ray generation.

    f = normalize(dir); r = normalize(f x up); u = normalize(r x f)
    x = ((j + 0.5)/nx)*2 - 1;  y = 1 - ((i + 0.5)/ny)*2      (NDC, y-up)
    d = r*(x*tan(alpha_w)) + u*(y*tan(alpha_h)) + f

Directions are normalized by :func:`camera_rays`; points and view dirs
both use the normalized direction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Pinhole camera. Fields are array-likes (numpy f32 from
    ``io.golden.camera_from_golden``) or tensors."""

    position: object       # (3,)
    forward: object        # (3,) need not be unit; normalized on use
    up: object             # (3,)
    alpha_width: object    # () FOV half-angle, atan(0.5*w/focal)
    alpha_height: object   # ()
    near: object           # ()
    far: object            # ()


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def camera_basis(cam: Camera, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Orthonormal (forward, right, true-up) basis on ``device``."""
    f = _normalize(_f32(cam.forward, device))
    r = _normalize(torch.linalg.cross(f, _f32(cam.up, device)))
    u = _normalize(torch.linalg.cross(r, f))
    return f, r, u


def ray_directions(cam: Camera, height: int, width: int, device) -> torch.Tensor:
    """Unnormalized ray directions for every pixel center -> (H, W, 3).
    Row i is image row (top to bottom), column j left to right."""
    f, r, u = camera_basis(cam, device)
    j = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width * 2.0 - 1.0
    i = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height * 2.0
    sx = torch.tan(_f32(cam.alpha_width, device))
    sy = torch.tan(_f32(cam.alpha_height, device))
    x = j[None, :, None] * sx  # (1, W, 1)
    y = i[:, None, None] * sy  # (H, 1, 1)
    return x * r + y * u + f   # (H, W, 3)


def camera_rays(cam: Camera, height: int, width: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins (H, W, 3), unit directions (H, W, 3)) on ``device``."""
    dirs = _normalize(ray_directions(cam, height, width, device))
    origins = torch.broadcast_to(_f32(cam.position, device), dirs.shape)
    return origins, dirs


def orbit_camera(cam: Camera, angle, target=(0.0, 0.0, 0.0)) -> Camera:
    """The camera rotated rigidly by ``angle`` radians about the world
    z-axis through ``target`` (default: the scene origin): a turntable
    sweep around the scene. Position, forward and up become float32 numpy
    arrays; ``angle=0`` gives them back unchanged (the rotation is then the
    identity exactly)."""
    a = np.float32(angle)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t = np.asarray(target, np.float32)

    def f32(v):
        return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float32)

    return cam._replace(position=rot @ (f32(cam.position) - t) + t, forward=rot @ f32(cam.forward),
                        up=rot @ f32(cam.up))
