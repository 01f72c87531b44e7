"""Static configuration dataclasses.

Field names and defaults are those of ``nerf_rs_tpu/config.py``, so configs
and CLI flags carry over between the two packages unchanged. The constants
come from the Rust reference renderer: image 256x256, 64+128 samples per
ray, encoding orders 10/4, transmittance early-out 1e-4, PDF floor 1e-5,
CDF denominator clamp 1e-6.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Multiresolution hash-encoding family (``models/hashgrid.py``;
    Mueller et al. 2022): L tables of T rows of F features, gathered at
    each sample's cell corners per level and trilinearly blended, then a
    tiny MLP. The defaults are the JAX package's, the paper's setting
    scaled to single-object scenes: T = 2^17 keeps the stacked table at
    16 MiB in f32 and 8 MiB in bf16."""

    levels: int = 16        # L resolution levels
    table_log2: int = 17    # log2 of the rows per level's table (T)
    features: int = 2       # feature channels per row (F)
    res_min: int = 16       # coarsest grid resolution (N_min)
    res_max: int = 1024     # finest grid resolution (N_max)
    width: int = 64         # density-MLP hidden width (one hidden layer)
    geo_features: int = 15  # geometry features fed to the color MLP
    #                         (density output dim = 1 + geo_features)
    color_width: int = 64   # color-MLP hidden width (two hidden layers)
    sh_degree: int = 4      # spherical-harmonics view encoding degree
    aabb: tuple = (-2.0, 2.0)   # scene bounds per axis, as accel's grids
    grad_impl: str = "scatter"  # table gradient: "scatter" (an accumulating
    #                             indexed add) or "sorted" (sort by row,
    #                             cumsum-difference segment sums)

    def replace(self, **kw) -> "HashGridConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs for the render pipeline.

    ``model`` selects the family: ``"mlp"`` (the reference network and
    its ArchConfig students) or ``"hashgrid"`` (``models.hashgrid``, with
    ``hash``; its encode is a hand-written CUDA kernel on CUDA tensors).
    Within the MLP family ``impl`` selects the field network:

    - ``"xla"``: the plain PyTorch MLP (``models.mlp.nerf_mlp``), the
      counterpart of the JAX package's XLA path;
    - ``"pallas"``: the port's hand-written CUDA kernel
      (``ops.kernels.fused_mlp.fused_nerf_mlp``), the counterpart of the
      JAX package's fused Pallas kernel. On CPU tensors it runs the
      kernel's plain PyTorch version.

    ``sampling_impl`` selects the resampling chain: ``"xla"`` the plain
    ops, ``"pallas"`` the hand-written CUDA kernel K3
    (``ops.kernels.resample.fused_resample``; its plain version on CPU
    tensors), on the inference path.

    ``impl="int8"`` serves the W8A8 family through the int8 CUDA kernel,
    ``impl="int8qat"`` its fake-quant STE forward (``models/quant.py``),
    both within the MLP family. Every ``accel_*`` field acts
    only with an occupancy grid (``accel.py``), with the JAX package's
    meanings: ``accel_compact`` "off" (the grid steers ray packing and
    sample placement only), "none" (mask-only culling), "scatter" /
    "gather" (fixed-capacity compaction); ``accel_cull_rays`` packs away
    the rays that cannot hit anything; ``accel_sample_aabb`` places each
    ray's samples in its occupied range, ``accel_aabb_probes`` refines it
    by probes, ``accel_range_stride`` probes a strided sub-grid of the
    image. ``host_chunk_rays`` splits device programs in the JAX package;
    the port already launches one ray chunk at a time, so every value
    renders the same image.
    """

    n_coarse: int = 64          # coarse stratified samples per ray
    n_fine: int = 128           # fine importance samples per ray (0: single pass)
    x_freqs: int = 10           # positional encoding bands for points
    d_freqs: int = 4            # positional encoding bands for view dirs
    white_background: bool = True
    t_threshold: float = 1e-4   # transmittance early-out; 0 disables
    pdf_eps: float = 1e-5       # importance-PDF floor
    cdf_eps: float = 1e-6       # CDF denominator clamp
    ray_chunk: int = 8192       # rays per render_rays call in image renders
    impl: str = "xla"           # MLP implementation: "xla" | "pallas"
    model: str = "mlp"          # field network family: "mlp" | "hashgrid"
    hash: HashGridConfig = dataclasses.field(default_factory=HashGridConfig)
    dtype: str = "float32"      # MLP compute dtype: "float32" | "bfloat16"
    sampling_impl: str = "xla"  # resampling chain: "xla" | "pallas"
    accel_coarse_capacity: float = 0.25
    accel_fine_capacity: float = 0.625
    accel_t_threshold: float = 1e-5
    accel_t_slack_bins: float = 2.0
    accel_sample_aabb: bool = False
    accel_aabb_probes: int = 0
    accel_pad_probes: float = 1.0
    accel_range_stride: int = 1
    host_chunk_rays: int = 0
    accel_compact: str = "none"
    accel_cull_rays: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """NeRF MLP architecture family: the canonical lego network is
    8x256 with a 128-wide view branch and the skip re-concatenation
    before dense5; students are narrower or shallower members."""

    width: int = 256      # trunk width
    v_width: int = 128    # view-branch width
    depth: int = 8        # dense trunk layers
    skip_at: int = 4      # encoded input re-concatenated BEFORE dense{skip_at+1}

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters: the original NeRF recipe, Adam from 5e-4
    decaying exponentially to 5e-6 over ``lr_decay_steps``. ``adam_eps``
    is the JAX package's default; the CLI's hash-grid recipe sets lr 1e-2
    decaying to 1e-4 and ``adam_eps`` 1e-15 (table gradients are minute
    under the default eps). ``checkpoint_every`` is the CLI's
    ``--checkpoint-every`` (``io/checkpoint.py``)."""

    batch_rays: int = 4096
    lr_init: float = 5e-4
    lr_final: float = 5e-6
    lr_decay_steps: int = 250_000
    n_steps: int = 200_000
    coarse_loss_weight: float = 1.0
    adam_eps: float = 1e-8
    checkpoint_every: int = 10_000
    seed: int = 0
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    arch: ArchConfig = dataclasses.field(default_factory=ArchConfig)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


# The reference's sample-count presets (coarse, fine): its native CLI and
# its WASM build.
NATIVE_SAMPLES = (64, 128)
WASM_SAMPLES = (32, 64)
