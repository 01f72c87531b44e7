"""Fused hierarchical resampler K3: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/resample.cu``) replaces the JAX package's Pallas kernel
``nerf_rs_tpu/ops/kernels/resample.py::_resample_call``, both of its
launches (``_kernel_extra`` and ``_kernel_merge``), with one launch. Per
ray it takes the coarse samples ``t_c`` and densities ``sigma_c``, the
uniforms ``u`` of the fine draws and ``far``, and returns the ascending
merge of ``t_c`` with the importance samples:

- deltas ``t[j+1] - t[j]``, the last one ``far - t[-1]``, clamped >= 0;
  ``alpha = 1 - exp(-sigma delta)``; the exclusive transmittance ``T``;
  weights ``T alpha``, zero where ``T < t_threshold``;
- the PDF of the interior weights ``w[1:-1]`` clamped >= 0 plus
  ``pdf_eps``, its CDF with the last entry exactly 1;
- per uniform the bin ``j`` with ``cdf[j] <= u < cdf[j+1]`` and the
  linear interpolation between bin midpoints, the denominator clamped at
  ``cdf_eps``;
- the merge of ``t_c`` with those samples, sorted ascending.

:func:`fused_resample_reference` is that chain in the port's plain ops
(``ops.volume.compute_weights``, ``ops.sampling.inverse_cdf``,
``ops.sampling.merge_samples``). :func:`fused_resample` launches the
kernel on CUDA tensors, counting each launch in ``fused_resample.launches``,
and runs the plain version on CPU tensors. Forward only: ``render.py``
detaches the inputs and re-attaches the coarse samples' gradients itself.

The TPU kernel served only power-of-two counts whose packed row filled its
vector lanes; this kernel serves ``3 <= Nc``, ``1 <= Nf`` and
``Nc + Nf <= MAX_ROW`` (:func:`supported`), and raises outside.
"""

from __future__ import annotations

import torch

from nerf_rs_tpu_torch.ops.kernels import _build
from nerf_rs_tpu_torch.ops.sampling import inverse_cdf, merge_samples
from nerf_rs_tpu_torch.ops.volume import compute_weights

MAX_ROW = 2048        # kMaxRow in csrc/resample.cu: a warp's row fits shared memory


def supported(nc: int, nf: int) -> bool:
    """The sample counts the kernel serves: ``3 <= nc``, ``1 <= nf`` and
    ``nc + nf <= MAX_ROW`` (each ray's row, padded to a power of two,
    stays in its warp's share of shared memory)."""
    return nc >= 3 and nf >= 1 and nc + nf <= MAX_ROW


def _per_ray_far(far, n: int) -> bool:
    """A far of more than one value is per ray, as the JAX package reads
    it; it must then hold one value per ray."""
    size = far.numel() if isinstance(far, torch.Tensor) else 1
    if size > 1 and size != n:
        raise ValueError(f"far holds {size} values for {n} rays")
    return size > 1


def fused_resample_reference(t_c: torch.Tensor, sigma_c: torch.Tensor, u: torch.Tensor, far, *,
                             t_threshold: float = 1e-4, pdf_eps: float = 1e-5,
                             cdf_eps: float = 1e-6) -> torch.Tensor:
    """K3's plain PyTorch version, on any device: ``compute_weights``,
    the inverse CDF on the given uniforms, then the sorted merge."""
    n = t_c.shape[0]
    if _per_ray_far(far, n):
        far = far.reshape(n, 1)
    w = compute_weights(sigma_c, t_c, far, t_threshold=t_threshold)
    t_extra = inverse_cdf(t_c, w, u, pdf_eps=pdf_eps, cdf_eps=cdf_eps)
    return merge_samples(t_c, t_extra)


def fused_resample(t_c: torch.Tensor, sigma_c: torch.Tensor, u: torch.Tensor, far, *,
                   t_threshold: float = 1e-4, pdf_eps: float = 1e-5,
                   cdf_eps: float = 1e-6) -> torch.Tensor:
    """(t_c (N, Nc) sorted per row, sigma_c (N, Nc), u (N, Nf), far) ->
    the merged, sorted t (N, Nc + Nf) float32. ``far`` is a scalar (a
    number or a one-value tensor) or one value per ray ((N,) or (N, 1)).

    CUDA tensors launch the kernel on the current stream without
    synchronizing; CPU tensors run :func:`fused_resample_reference`.
    Counts outside :func:`supported` raise NotImplementedError. Forward
    only: the inputs must not need gradients.
    """
    nc, nf = int(t_c.shape[-1]), int(u.shape[-1])
    if not supported(nc, nf):
        raise NotImplementedError(
            f"fused_resample serves 3 <= Nc, 1 <= Nf and Nc + Nf <= {MAX_ROW}; got "
            f"({nc}, {nf}) — use sampling_impl='xla'")
    n = int(t_c.shape[0])
    if t_c.shape != (n, nc) or sigma_c.shape != (n, nc) or u.shape != (n, nf):
        raise ValueError(f"expected t_c and sigma_c (N, Nc) and u (N, Nf), got "
                         f"{tuple(t_c.shape)}, {tuple(sigma_c.shape)}, {tuple(u.shape)}")
    if any(x.requires_grad for x in (t_c, sigma_c, u)):
        raise ValueError("fused_resample is forward only: detach its inputs")
    dev = t_c.device
    if n == 0:
        return torch.zeros((0, nc + nf), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return fused_resample_reference(t_c, sigma_c, u, far, t_threshold=t_threshold,
                                        pdf_eps=pdf_eps, cdf_eps=cdf_eps)
    if dev.type != "cuda":
        raise ValueError(f"fused_resample takes CPU or CUDA tensors, got {dev}")
    if sigma_c.device != dev or u.device != dev:
        raise ValueError(f"t_c on {dev}, sigma_c on {sigma_c.device}, u on {u.device}")
    t_c, sigma_c, u = (x.to(torch.float32).contiguous() for x in (t_c, sigma_c, u))
    per_ray = _per_ray_far(far, n)
    far_ptr, far_value = None, 0.0            # a number goes to the kernel by value
    if isinstance(far, torch.Tensor):
        if far.requires_grad:
            raise ValueError("fused_resample is forward only: detach far")
        far = far.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
        far_ptr = far.data_ptr()
    else:
        far_value = float(far)
    out = torch.empty((n, nc + nf), dtype=torch.float32, device=dev)
    err = _build.load_library().nerf_fused_resample(
        t_c.data_ptr(), sigma_c.data_ptr(), u.data_ptr(), far_ptr, int(per_ray), far_value, n,
        nc, nf, float(t_threshold), float(pdf_eps), float(cdf_eps), out.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused resample kernel launch failed with CUDA error {err}")
    fused_resample.launches += 1
    return out


fused_resample.launches = 0
