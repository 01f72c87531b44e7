"""The classic NeRF density+RGB MLP, plain PyTorch forward.

This is the port's numerical oracle, as ``nerf_rs_tpu/models/mlp.py`` is
the JAX package's:

    h0 = gamma_10(points)                        (63)
    dense0..4 + ReLU                             (63->256, 256->256 x4)
    skip: h = concat(h0, h4)                     (319)
    dense5..7 + ReLU                             (319->256, 256->256 x2)
    sigma  = ReLU(alpha(h8))                     (1)     ReLU, not softplus
    b      = bottleneck(h8), no activation       (256)
    q      = concat(b, gamma_4(viewdirs))        (283)
    hv     = ReLU(viewdirs_layer(q))             (128)
    rgb    = Sigmoid(rgb_layer(hv))              (3)

Activations are batch-major ``(..., features)`` and layers compute
``x @ kernel + bias``. Float32 products are true float32: the package turns
TF32 off where it is imported (``nerf_rs_tpu_torch/__init__.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nerf_rs_tpu_torch.io.weights import param_layer_names, validate_param_chain
from nerf_rs_tpu_torch.models.encoding import positional_encoding


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    p = params[name]
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _tree(params):
    return params.tree() if isinstance(params, NerfMLP) else params


def nerf_mlp(
    params,
    points: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    x_freqs: int = 10,
    d_freqs: int = 4,
    sigma_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the MLP at ``points`` (..., 3) with view dirs (..., 3).

    ``params`` is a param tree or a :class:`NerfMLP`. ``viewdirs``
    broadcasts against points' batch shape. Returns ``(rgb (..., 3),
    sigma (...,))`` in the inputs' dtype. With ``sigma_only`` the color
    branch is skipped and rgb is zeros (the coarse pass discards colors).
    """
    params = _tree(params)
    h0 = positional_encoding(points, x_freqs)
    h = h0
    # Depth and skip placement come from the params: a layer whose input
    # dim exceeds the running width by exactly enc_dim takes the skip.
    n_dense = sum(1 for k in params if k.startswith("dense"))
    enc_dim = h0.shape[-1]
    for i in range(n_dense):
        d_in = params[f"dense{i}"]["kernel"].shape[0]
        if i > 0 and d_in == h.shape[-1] + enc_dim:
            h = torch.cat([h0, h], dim=-1)       # encoded input FIRST
        h = torch.relu(_dense(params, f"dense{i}", h))

    sigma = torch.relu(_dense(params, "alpha", h))[..., 0]
    if sigma_only:
        return torch.zeros((*sigma.shape, 3), dtype=sigma.dtype, device=sigma.device), sigma

    bottleneck = _dense(params, "bottleneck", h)
    dirs_enc = positional_encoding(viewdirs, d_freqs)
    dirs_enc = torch.broadcast_to(dirs_enc, (*bottleneck.shape[:-1], dirs_enc.shape[-1]))
    q = torch.cat([bottleneck, dirs_enc], dim=-1)   # bottleneck FIRST
    hv = torch.relu(_dense(params, "viewdirs", q))
    rgb = torch.sigmoid(_dense(params, "rgb", hv))
    return rgb, sigma


def arch_shapes(arch=None, x_freqs: int = 10, d_freqs: int = 4) -> Dict[str, Tuple[int, int]]:
    """Layer name -> (d_in, d_out) for an :class:`ArchConfig` family member
    (the canonical default gives the lego shapes)."""
    from nerf_rs_tpu_torch.config import ArchConfig

    arch = arch or ArchConfig()
    enc_x = 3 + 6 * x_freqs
    enc_d = 3 + 6 * d_freqs
    shapes: Dict[str, Tuple[int, int]] = {}
    d_in = enc_x
    for i in range(arch.depth):
        if i == arch.skip_at + 1:
            d_in += enc_x          # skip concat feeds this layer
        shapes[f"dense{i}"] = (d_in, arch.width)
        d_in = arch.width
    shapes["bottleneck"] = (arch.width, arch.width)
    shapes["viewdirs"] = (arch.width + enc_d, arch.v_width)
    shapes["rgb"] = (arch.v_width, 3)
    shapes["alpha"] = (arch.width, 1)
    return shapes


def init_nerf_params(generator: torch.Generator, arch=None,
                     dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random init on ``generator``'s device: Glorot-uniform kernels and
    zero biases (TF Dense defaults). ``arch`` picks the family member
    (default: canonical lego)."""
    device = generator.device
    params = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        limit = float(np.sqrt(6.0 / (d_in + d_out)))
        u = torch.rand((d_in, d_out), generator=generator, device=device, dtype=dtype)
        params[layer] = {"kernel": (2.0 * u - 1.0) * limit,
                         "bias": torch.zeros((d_out,), dtype=dtype, device=device)}
    return params


def count_params(params) -> int:
    return sum(int(np.prod(p.shape)) for layer in _tree(params).values()
               for p in layer.values())


class NerfMLP(nn.Module):
    """One NeRF network: its f32 params, and the packed weights that the
    fused kernel reads.

    Packs are built on first use per compute dtype and kept until the
    module moves (``.to``/``.cuda`` clear them) or a parameter is modified
    in place (tracked by the tensors' version counters), so a render packs
    each network once, not on every kernel call.
    """

    def __init__(self, params, *, device=None, requires_grad: bool = False):
        super().__init__()
        validate_param_chain(params)
        self.layer_names = param_layer_names(params)
        self.weights = nn.ParameterDict()
        for layer in self.layer_names:
            for part in ("kernel", "bias"):
                t = params[layer][part]
                if not isinstance(t, torch.Tensor):
                    t = torch.as_tensor(np.array(t))
                self.weights[f"{layer}_{part}"] = nn.Parameter(
                    t.detach().to(device=device, dtype=torch.float32).clone(),
                    requires_grad=requires_grad)
        self._packs = {}

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {layer: {"kernel": self.weights[f"{layer}_kernel"],
                        "bias": self.weights[f"{layer}_bias"]}
                for layer in self.layer_names}

    def packed(self, dtype: str):
        """The fused kernel's packed weights for compute ``dtype``."""
        from nerf_rs_tpu_torch.ops.kernels.fused_mlp import pack_params

        versions = tuple(p._version for p in self.parameters())
        hit = self._packs.get(dtype)
        if hit is None or hit[0] != versions:
            hit = (versions, pack_params(self.tree(), dtype))
            self._packs[dtype] = hit
        return hit[1]

    def _apply(self, fn, *args, **kwargs):
        self._packs = {}
        return super()._apply(fn, *args, **kwargs)

    def forward(self, points, viewdirs, *, x_freqs: int = 10, d_freqs: int = 4,
                sigma_only: bool = False):
        return nerf_mlp(self.tree(), points, viewdirs, x_freqs=x_freqs,
                        d_freqs=d_freqs, sigma_only=sigma_only)


def as_module(params, device):
    """``params`` (a param tree, a NerfMLP or a hash-grid field) as a
    module on ``device``: a NerfMLP, or a ``models.hashgrid.HashGridField``
    for a hash-grid tree."""
    from nerf_rs_tpu_torch.models.hashgrid import HashGridField, is_hashgrid_params

    if isinstance(params, (NerfMLP, HashGridField)):
        return params.to(device)
    if is_hashgrid_params(params):
        return HashGridField(params, device=device)
    return NerfMLP(params, device=device)
