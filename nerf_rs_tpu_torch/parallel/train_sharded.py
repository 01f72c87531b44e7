"""Data-parallel training over the ``torch.distributed`` world.

The batch's per-ray arrays are split into contiguous per-rank rows; the
networks and Adam's moments are replicated. Each rank runs the forward and
backward on its rows with global ray ids (so every ray's jitter is the
single-device step's), then one all-reduce of one flat buffer pools the
gradients and the metrics together, as the JAX step's single fused
``pmean`` does, and every rank takes the same Adam update. The occupancy
grid of a culled step is not communicated: every rank builds it from the
same student.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from nerf_rs_tpu_torch.config import TrainConfig
from nerf_rs_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_rows, replicate
from nerf_rs_tpu_torch.train import TrainState, create_train_state, make_optimizer, nerf_loss


def shard_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The rank's rows of the per-ray arrays ((B, ...), ndim >= 2) on its
    device; scalars and a shared (3,) origin stay whole."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=mesh.device)
        out[k] = v[rank_rows(mesh, v.shape[0])] if v.dim() >= 2 else v
    return out


def create_sharded_train_state(generator: torch.Generator, cfg: TrainConfig,
                               mesh: Optional[Mesh] = None) -> Tuple[Mesh, TrainState]:
    """``train.create_train_state``, then rank 0's state on every rank."""
    mesh = mesh or make_mesh(generator.device)
    return mesh, replicate(mesh, create_train_state(generator, cfg))


def _pool(mesh: Mesh, state: TrainState, metrics: Dict[str, torch.Tensor], stop) -> None:
    """Every parameter's gradient (zeros where it has none, so every rank
    packs the same layout), the metrics and the stop request in one flat
    buffer, all-reduced once and divided by the world size; the pooled
    values go back in place."""
    params = [p for module in state.params.values() for p in module.weights.values()]
    names = sorted(metrics)
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
             for p in params]
    scalars = [metrics[k].to(torch.float32) for k in names]
    if stop is not None:
        # A fill on the device: a scalar copied from the host would wait
        # for the step's queued work.
        scalars.append(torch.full((), float(stop), device=mesh.device))
    flat = torch.cat(parts + [torch.stack(scalars)])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    for i, k in enumerate(names + (["stop"] if stop is not None else [])):
        metrics[k] = flat[offset + i]


def sharded_train_step(mesh: Mesh, state: TrainState, batch: Dict[str, torch.Tensor],
                       key: torch.Tensor, cfg: TrainConfig, grid=None, *,
                       stop: Optional[bool] = None
                       ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One data-parallel Adam step on the global ``batch`` (every rank
    holds the same one), in place; returns the state and the pooled
    metrics. ``grid`` (``accel.OccupancyGrid``) culls every rank's render.

    ``stop`` (this rank's stop request) rides in the step's all-reduce;
    the metrics then hold ``stop``, above 0 on every rank when any rank
    asked, so that all ranks stop after the same step. A world without a
    process group makes no collective: the step is ``train.train_step``.
    """
    n_total = batch["dirs"].shape[0]
    if n_total % mesh.size:
        raise ValueError(f"batch of {n_total} rays does not divide over {mesh.size} devices")
    local = shard_batch(mesh, batch)
    n_local = n_total // mesh.size
    ray_ids = mesh.rank * n_local + torch.arange(n_local, dtype=torch.int64, device=mesh.device)
    for module in state.params.values():
        module.zero_grad(set_to_none=True)
    loss, metrics = nerf_loss(state.params, local, key, cfg, grid=grid, ray_ids=ray_ids)
    loss.backward()
    if mesh.group is not None:
        del metrics["psnr"]
        _pool(mesh, state, metrics, stop)
        # psnr is not linear in the mse: recomputed from the pooled mse.
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp(metrics["mse_fine"], min=1e-10))
    elif stop is not None:
        metrics["stop"] = torch.tensor(float(stop))
    make_optimizer(cfg).update(state)
    state.step += 1
    return state, metrics
