"""Multiresolution hash-grid NeRF (Instant-NGP family), the port of
``nerf_rs_tpu/models/hashgrid.py``.

The multiresolution hash encoding of Mueller et al. 2022 replaces the
sinusoidal features and the 8x256 trunk of the MLP family with L small
feature tables, gathered and trilinearly interpolated at each sample point,
followed by a tiny MLP:

    enc   = hash_encode(tables, points)              (L*F)
    h     = ReLU(sigma0(enc))                        (width)
    geo   = sigma1(h)                                (1 + geo_features)
    sigma = trunc_exp(geo[0])
    rgb   = Sigmoid(color2(ReLU(color1(ReLU(color0(concat(geo, SH(dirs))))))))

Levels whose dense grid fits the table (``(N+1)^3 <= T``) index directly;
finer ones hash the cell's corner with the paper's primes. All levels share
one ``(L, T, F)`` tensor, read by the encode as its flat ``(L*T, F)`` view.

:func:`hash_encode` runs the CUDA kernel on CUDA tensors and its plain
version on CPU tensors (``ops/kernels/hash_encode.py``). The tiny MLP's
products are ``torch.matmul``, as the JAX package leaves them to XLA.
:func:`hashgrid_mlp` has the contract of ``models.mlp.nerf_mlp``, so every
render, accel and training path serves this family unchanged
(``render.get_mlp_fn`` dispatches on ``RenderConfig.model``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# Spatial-hash primes of the paper (Sec. 3, eq. 4).
_PRIMES = (1, 2654435761, 805459861)

# Real spherical-harmonics basis constants, degree <= 4.
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)

# The 8 trilinear corner offsets (bx, by, bz), bz fastest: the order in
# which the encode sums the corners.
_CORNERS = np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"), axis=-1).reshape(8, 3)

LAYERS = ("sigma0", "sigma1", "color0", "color1", "color2")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis of unit ``dirs`` (..., 3) -> (..., degree**2)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh_degree must be in [1, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z,
                _C3[2] * y * (4.0 * zz - xx - yy),
                _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy),
                _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, dim=-1)


def level_resolutions(cfg) -> Tuple[int, ...]:
    """Per-level grid resolutions N_l = round(N_min * b**l), with the
    paper's geometric growth factor b, in Python floats: round(), not
    floor(), so that res_min and res_max hold exactly at both ends."""
    if cfg.levels == 1:
        return (cfg.res_min,)
    b = math.exp((math.log(cfg.res_max) - math.log(cfg.res_min)) / (cfg.levels - 1))
    return tuple(int(round(cfg.res_min * b ** l)) for l in range(cfg.levels))


def hash_encode(tables: torch.Tensor, points: torch.Tensor, cfg) -> torch.Tensor:
    """Multiresolution hash encoding: (..., 3) world points -> (..., L*F)
    in the tables' dtype, differentiable in the tables and the points.

    ``tables`` is (L, T, F). Points are normalized into ``cfg.aabb``;
    out-of-box and non-finite points clamp to the border cell. CUDA tensors
    launch the kernel, once a block of up to 64 levels
    (``ops.kernels.hash_encode.blocked_hash_encode``), CPU tensors run its
    plain version.
    """
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import blocked_hash_encode

    return blocked_hash_encode(tables, points, cfg)


def _trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of the input clipped to [-15, 15], the paper's density
    activation; the clip zeroes gradients outside it."""
    return torch.exp(torch.clamp(x, -15.0, 15.0))


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    p = params[name]
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _tree(params):
    return params.tree() if isinstance(params, HashGridField) else params


def hashgrid_mlp(params, points: torch.Tensor, viewdirs: torch.Tensor, *, cfg,
                 dtype: str = "float32", sigma_only: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the hash-grid field (a param tree or a
    :class:`HashGridField`) at ``points`` (..., 3) with unit view dirs
    broadcastable against them -> ``(rgb (..., 3), sigma (...,))`` f32, the
    contract of ``models.mlp.nerf_mlp``. ``dtype`` is the compute dtype of
    the tables and the MLP."""
    dt = _DTYPES[dtype]
    params = _tree(params)
    enc = hash_encode(params["hash_tables"].to(dt), points, cfg).to(dt)
    h = torch.relu(_dense(params, "sigma0", enc))
    geo = _dense(params, "sigma1", h)                 # (..., 1 + geo_features)
    sigma = _trunc_exp(geo[..., 0].to(torch.float32))
    if sigma_only:
        return torch.zeros((*sigma.shape, 3), dtype=torch.float32, device=sigma.device), sigma
    sh = sh_encoding(viewdirs, cfg.sh_degree).to(dt)
    sh = torch.broadcast_to(sh, (*geo.shape[:-1], sh.shape[-1]))
    hc = torch.cat([geo, sh], dim=-1)
    hc = torch.relu(_dense(params, "color0", hc))
    hc = torch.relu(_dense(params, "color1", hc))
    rgb = torch.sigmoid(_dense(params, "color2", hc).to(torch.float32))
    return rgb, sigma


def layer_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """Layer name -> (d_in, d_out) of the tiny MLP."""
    geo = 1 + cfg.geo_features
    return {"sigma0": (cfg.levels * cfg.features, cfg.width),
            "sigma1": (cfg.width, geo),
            "color0": (geo + cfg.sh_degree ** 2, cfg.color_width),
            "color1": (cfg.color_width, cfg.color_width),
            "color2": (cfg.color_width, 3)}


def init_hashgrid_params(generator: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    """Random init on ``generator``'s device, the JAX package's
    distributions: tables U(-1e-4, 1e-4) (paper Sec. 4), Glorot-uniform
    kernels and zero biases. The tables are drawn first, then the layers
    in order."""
    device = generator.device

    def uniform(shape, limit):
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return (2.0 * u - 1.0) * limit

    params: Dict = {"hash_tables": uniform((cfg.levels, 1 << cfg.table_log2, cfg.features),
                                           1e-4)}
    for name, (d_in, d_out) in layer_shapes(cfg).items():
        params[name] = {"kernel": uniform((d_in, d_out), math.sqrt(6.0 / (d_in + d_out))),
                        "bias": torch.zeros((d_out,), dtype=dtype, device=device)}
    return params


def is_hashgrid_params(params) -> bool:
    """True for a param tree or module of this family."""
    return isinstance(params, HashGridField) or (isinstance(params, dict)
                                                 and "hash_tables" in params)


class HashGridField(nn.Module):
    """One hash-grid field: its f32 tables and MLP params in ``weights``
    (``hash_tables``, ``{layer}_kernel``, ``{layer}_bias``), the interface
    of ``models.mlp.NerfMLP`` that ``train.Adam`` and ``as_module`` use.
    The training state holds one field that serves both passes."""

    def __init__(self, params, *, device=None, requires_grad: bool = False):
        super().__init__()
        missing = [name for name in ("hash_tables", *LAYERS) if name not in params]
        if missing:
            raise ValueError(f"hash-grid params lack {missing}")
        self.weights = nn.ParameterDict()

        def param(t):
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.array(t))
            return nn.Parameter(t.detach().to(device=device, dtype=torch.float32).clone(),
                                requires_grad=requires_grad)

        self.weights["hash_tables"] = param(params["hash_tables"])
        for layer in LAYERS:
            for part in ("kernel", "bias"):
                self.weights[f"{layer}_{part}"] = param(params[layer][part])

    def tree(self) -> Dict:
        out: Dict = {"hash_tables": self.weights["hash_tables"]}
        for layer in LAYERS:
            out[layer] = {"kernel": self.weights[f"{layer}_kernel"],
                          "bias": self.weights[f"{layer}_bias"]}
        return out

    def forward(self, points, viewdirs, *, cfg, dtype: str = "float32", sigma_only: bool = False):
        return hashgrid_mlp(self.tree(), points, viewdirs, cfg=cfg, dtype=dtype,
                            sigma_only=sigma_only)


def hashgrid_params_from_numpy(tree, device) -> Dict:
    """The JAX package's hash-grid tree of numpy arrays (``{"hash_tables":
    (L, T, F), "sigma0": {"kernel", "bias"}, ...}``) as f32 tensors on
    ``device``."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).clone()

    out: Dict = {"hash_tables": tensor(tree["hash_tables"])}
    for layer in LAYERS:
        out[layer] = {part: tensor(tree[layer][part]) for part in ("kernel", "bias")}
    return out
