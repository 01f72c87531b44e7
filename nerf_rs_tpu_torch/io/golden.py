"""Golden-fixture loader: ``tf_reference_samples.json``.

The JSON carries the lego camera (near/far/origin/forward/up/hwf), fixed
z_vals, and three example rays with golden sigma/RGB outputs from the
original TensorFlow NeRF.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from nerf_rs_tpu_torch.ops.rays import Camera


def load_golden(path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def camera_from_golden(samples: Dict[str, Any]) -> Camera:
    """Camera from the golden JSON: forward/up normalized, FOV half angles
    atan(0.5*{w,h}/focal) from hwf=[h, w, focal]. Fields are numpy f32;
    ``ops.rays.camera_rays`` moves them to the render's device."""
    hwf = samples["hwf"]
    hh, hw, focal = float(hwf[0]), float(hwf[1]), float(hwf[2])

    def unit(v):
        v = np.asarray(v, dtype=np.float32)
        return v / np.linalg.norm(v)

    return Camera(
        position=np.asarray(samples["camera_origin"], dtype=np.float32),
        forward=unit(samples["camera_forward"]),
        up=unit(samples["camera_up"]),
        alpha_width=np.float32(np.arctan(0.5 * hw / focal)),
        alpha_height=np.float32(np.arctan(0.5 * hh / focal)),
        near=np.float32(samples["near"]),
        far=np.float32(samples["far"]),
    )


def golden_examples(samples: Dict[str, Any]):
    """Yield one dict per example ray. Sample points use the
    *unnormalized* ray_d while the network's view-dir input is the
    separately supplied unit vector (the TF convention)."""
    z_vals = np.asarray(samples["z_vals"], dtype=np.float32)
    for ex in samples["examples"]:
        yield {
            "pixel": ex["pixel"],
            "ray_o": np.asarray(ex["ray_o"], dtype=np.float32),
            "ray_d": np.asarray(ex["ray_d"], dtype=np.float32),
            "viewdir_unit": np.asarray(ex["viewdir_unit"], dtype=np.float32),
            "z_vals": z_vals,
            "coarse_sigma": np.asarray(ex["coarse_sigma"], dtype=np.float32),
            "coarse_rgb": np.asarray(ex["coarse_rgb"], dtype=np.float32),
            "fine_sigma": np.asarray(ex["fine_sigma"], dtype=np.float32),
            "fine_rgb": np.asarray(ex["fine_rgb"], dtype=np.float32),
        }
