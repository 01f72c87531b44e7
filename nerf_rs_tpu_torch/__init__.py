"""nerf_rs_tpu_torch — the PyTorch / CUDA port of ``nerf_rs_tpu``.

The JAX package beside it is the reference: module paths, function names,
param trees and array layouts are the same, so each module's counterpart
is easy to find and the tests feed both packages the same inputs. The
fused MLP forward and backward, the fused resampler and the hash-grid
family's multiresolution hash encode are hand-written CUDA kernels for
Hopper (``ops/kernels/csrc/``); everything else is plain PyTorch.
``parallel/`` splits frames and training batches over the ranks of a
``torch.distributed`` world, one process a device (NCCL between cards,
gloo on the CPU), as the JAX package splits them over a device mesh. This
package never imports JAX.

Float32 matmuls are true float32 (TF32 off), the counterpart of the JAX
oracle's ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from nerf_rs_tpu_torch.config import (  # noqa: E402
    ArchConfig,
    HashGridConfig,
    RenderConfig,
    TrainConfig,
)
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params, nerf_mlp  # noqa: E402
from nerf_rs_tpu_torch.models.hashgrid import hashgrid_mlp, init_hashgrid_params  # noqa: E402
from nerf_rs_tpu_torch.models.encoding import positional_encoding  # noqa: E402
from nerf_rs_tpu_torch.io.weights import (  # noqa: E402
    load_nerf_params,
    params_to_torch,
    save_nerf_params,
)
from nerf_rs_tpu_torch.render import render_image, render_image_aux, render_rays  # noqa: E402
from nerf_rs_tpu_torch.accel import OccupancyGrid, build_scene_grid  # noqa: E402
from nerf_rs_tpu_torch.extract import extract_scene_mesh, save_ply  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ArchConfig",
    "HashGridConfig",
    "RenderConfig",
    "TrainConfig",
    "nerf_mlp",
    "init_nerf_params",
    "NerfMLP",
    "hashgrid_mlp",
    "init_hashgrid_params",
    "positional_encoding",
    "load_nerf_params",
    "save_nerf_params",
    "params_to_torch",
    "render_rays",
    "render_image",
    "render_image_aux",
    "OccupancyGrid",
    "build_scene_grid",
    "extract_scene_mesh",
    "save_ply",
    "__version__",
]
