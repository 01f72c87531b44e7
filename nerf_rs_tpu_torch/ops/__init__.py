from nerf_rs_tpu_torch.ops.rays import Camera, camera_rays, ray_directions
from nerf_rs_tpu_torch.ops.sampling import importance_samples, merge_samples, stratified_samples
from nerf_rs_tpu_torch.ops.volume import composite, compute_weights, integrate

__all__ = [
    "Camera",
    "camera_rays",
    "ray_directions",
    "stratified_samples",
    "importance_samples",
    "merge_samples",
    "compute_weights",
    "composite",
    "integrate",
]
