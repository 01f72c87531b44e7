"""Bringing up the ``torch.distributed`` world, and multi-process renders.

The JAX package calls ``jax.distributed.initialize`` on every host and then
runs one program over the global mesh. The port runs one process per
device, launched by ``python -m torch.distributed.run`` (torchrun), which
sets ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``
in each process; :func:`initialize` joins that world. torchrun's
variables are the port's cluster detection: PyTorch has no counterpart of
JAX's own auto-detection (``$NERF_MULTIHOST_AUTO`` in the JAX package).
NCCL carries the collectives between cards, gloo between CPU processes.

Rendering across processes: each rank renders its contiguous rows of the
padded ray axis (``render_sharded.render_flat_sharded``) and
:func:`gather_image_shards` assembles them on rank 0 for the writer.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from nerf_rs_tpu_torch.config import RenderConfig
from nerf_rs_tpu_torch.parallel.mesh import Mesh, all_gather_rows, make_mesh, shard_rays
from nerf_rs_tpu_torch.parallel.render_sharded import (
    _round_up,
    effective_chunk,
    render_flat_sharded,
)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device=None,
               timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group (env-var driven, as torchrun launches).

    Arguments default to torchrun's ``$WORLD_SIZE`` and ``$RANK``, and
    ``init_method`` to ``env://`` (``$MASTER_ADDR``/``$MASTER_PORT``); a
    ``file://`` path works too. When neither arguments nor environment
    name a world nothing is attempted: single-process start-up stays cheap
    and offline. ``device`` (default: the card) picks the backend: NCCL
    for a CUDA device, after ``torch.cuda.set_device($LOCAL_RANK)`` so that
    every kernel launch of the rank lands on its own card, and then the
    kernels are built and loaded once a host (:func:`load_kernels_in_turn`);
    gloo for the CPU. Returns True when the world is larger than 1. A
    second call is a no-op."""
    if not dist.is_initialized():
        world_size = world_size if world_size is not None else (
            int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ else None)
        rank = rank if rank is not None else (
            int(os.environ["RANK"]) if "RANK" in os.environ else None)
        if init_method is None and world_size is None:
            return False
        cuda = torch.device(device if device is not None else "cuda").type == "cuda"
        kw = {}
        if cuda:
            local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(local)
            kw["device_id"] = local
        if timeout is not None:
            kw["timeout"] = timeout
        dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method or "env://",
                                world_size=world_size if world_size is not None else -1,
                                rank=rank if rank is not None else -1, **kw)
        if cuda:
            load_kernels_in_turn()
    return dist.get_world_size() > 1


def load_kernels_in_turn() -> None:
    """Build and load the port's CUDA kernels (``_build.load_library``)
    once a host: the host's first rank (``$LOCAL_RANK`` 0, else rank 0)
    before a barrier, the other ranks after it, where they find its
    library, so that a world of N ranks does not run every ``nvcc`` job N
    times. Every rank of the world calls it, once, when it joins."""
    from nerf_rs_tpu_torch.ops.kernels import _build

    first = int(os.environ.get("LOCAL_RANK", dist.get_rank())) == 0
    if first:
        _build.load_library()
    dist.barrier()
    if not first:
        _build.load_library()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_ray_slice(n_rays: int, cfg=None, mesh: Optional[Mesh] = None) -> slice:
    """The slice of real (unpadded) global ray indices this rank renders,
    matching ``render_flat_sharded``'s layout: the padded ray axis split
    ``n_per_dev`` rows a rank, ``n_per_dev`` rounded up to the effective
    chunk (a plain ceil(n / size) disagrees whenever that rounds up)."""
    mesh = mesh or make_mesh()
    chunk = effective_chunk(n_rays, mesh.size, cfg or RenderConfig())
    n_per_dev = _round_up(-(-n_rays // mesh.size), chunk)
    lo = mesh.rank * n_per_dev
    return slice(min(lo, n_rays), min(lo + n_per_dev, n_rays))


def gather_image_shards(local_pixels: torch.Tensor, n_rays: int,
                        mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """Every rank's equal-sized rows, in rank order, cut to ``n_rays``, on
    rank 0 (None elsewhere): one all-gather. A world without a process
    group returns its rows cut to ``n_rays``."""
    mesh = mesh or make_mesh()
    full = all_gather_rows(mesh, local_pixels)
    return full[:n_rays] if mesh.rank == 0 else None


def local_ray_rows(rgb_flat: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's rows of a flat array laid out over the world (the
    JAX package reads them from the array's addressable shards)."""
    return shard_rays(mesh or make_mesh(), rgb_flat)


def render_image_multihost(params_coarse, params_fine, camera, height: int, width: int, key,
                           cfg=None, grid=None, mesh: Optional[Mesh] = None
                           ) -> Optional[torch.Tensor]:
    """Multi-process render: every rank renders its rows of the frame
    (``render_sharded.render_flat_sharded``), then the rows are gathered
    to rank 0. Returns the (height, width, 3) image on rank 0, None
    elsewhere; bitwise ``render.render_image`` (global-ray-index streams)
    under ``render_sharded.render_image_sharded``'s one exception. A world
    of 1 returns its own frame."""
    mesh = mesh or make_mesh()
    rgb, n = render_flat_sharded(params_coarse, params_fine, camera, height, width, key, cfg,
                                 mesh=mesh, grid=grid)
    full = gather_image_shards(rgb, n, mesh)
    return None if full is None else full.reshape(height, width, 3)
