from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.image import load_ppm, pixels_to_rgba, quantize_u8, save_png, save_ppm
from nerf_rs_tpu_torch.io.weights import (
    find_lego_assets,
    load_bundle,
    load_nerf_params,
    load_scene_assets,
    params_to_torch,
    save_bundle,
)

__all__ = [
    "load_nerf_params",
    "params_to_torch",
    "find_lego_assets",
    "save_bundle",
    "load_bundle",
    "load_scene_assets",
    "pixels_to_rgba",
    "load_golden",
    "camera_from_golden",
    "save_ppm",
    "save_png",
    "load_ppm",
    "quantize_u8",
]
