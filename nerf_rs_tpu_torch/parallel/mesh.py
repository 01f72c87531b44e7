"""The data-parallel world and its layout.

The JAX package runs one process over a 1-D ``jax.sharding.Mesh`` whose
axis ``"rays"`` splits the ray batch across devices, with the MLP
parameters replicated (``ray_sharding`` and ``replicated_sharding`` are
``NamedSharding``s of that mesh). PyTorch's counterpart is one process per
device under ``torch.distributed``: a :class:`Mesh` is this process's place
in that world, :func:`shard_rays` takes the rank's contiguous rows (the
counterpart of ``ray_sharding``) and :func:`replicate` broadcasts rank 0's
tensors in place (the counterpart of ``replicated_sharding``). Without an
initialized process group the world is one device and nothing is
communicated. Tensor, pipeline and expert parallelism do not apply to a
595K-parameter MLP.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``size`` ranks, this process's ``rank``, its ``device`` and the
    process ``group`` (None for a world of 1 without ``torch.distributed``,
    where no collective runs)."""

    size: int
    rank: int
    device: torch.device
    group: Any = None


def _rank_device(device) -> torch.device:
    """The rank's device: ``cuda:$LOCAL_RANK`` unless ``device`` names
    another (a CUDA device without an index is the rank's card)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(device=None) -> Mesh:
    """The world of the default process group when ``torch.distributed``
    is initialized, each rank on ``cuda:$LOCAL_RANK`` unless ``device``
    names another (the CPU only when named, whatever the backend);
    otherwise a world of 1 on ``device``, by default the card (JAX's
    ``make_mesh`` over one device)."""
    if dist.is_initialized():
        return Mesh(size=dist.get_world_size(), rank=dist.get_rank(),
                    device=_rank_device(device), group=dist.group.WORLD)
    return Mesh(size=1, rank=0, device=torch.device(device if device is not None else "cuda"))


def rank_rows(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous rows of ``n`` rows split evenly over the
    world."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_rays(mesh: Mesh, *tensors):
    """This rank's contiguous rows of each tensor's leading (ray) axis."""
    out = tuple(t[rank_rows(mesh, t.shape[0])] for t in tensors)
    return out[0] if len(out) == 1 else out


def all_gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's equal-sized rows in rank order, on every rank: one
    all-gather (none in a world without a process group)."""
    if mesh.group is None:
        return local
    local = local.contiguous()
    out = local.new_empty((mesh.size * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local, group=mesh.group)
    return out


def _tensors(obj, out: list) -> list:
    """Every tensor in ``obj``: modules' parameters and buffers, and the
    values of dicts, lists, tuples and dataclasses, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, dict):
        for value in obj.values():
            _tensors(value, out)
    elif isinstance(obj, (list, tuple)):
        for value in obj:
            _tensors(value, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for field in dataclasses.fields(obj):
            _tensors(getattr(obj, field.name), out)
    return out


@torch.no_grad()
def replicate(mesh: Mesh, obj):
    """Rank 0's values of every tensor in ``obj`` (modules, tensors, and
    dicts, lists or dataclasses of them, such as a ``train.TrainState``)
    on every rank, in place: one broadcast of one flat buffer per dtype.
    Returns ``obj``. A world without a process group has nothing to do."""
    if mesh.group is None:
        return obj
    by_dtype = {}
    for t in _tensors(obj, []):
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return obj
