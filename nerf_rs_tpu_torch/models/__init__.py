from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params, nerf_mlp

__all__ = ["positional_encoding", "nerf_mlp", "init_nerf_params", "NerfMLP"]
