"""Data parallelism over ``torch.distributed``, the port of
``nerf_rs_tpu/parallel/``: one process per device (NCCL between cards, gloo
on the CPU), rays split into contiguous per-rank rows, networks replicated.
"""

from nerf_rs_tpu_torch.parallel.mesh import Mesh, RAY_AXIS, make_mesh, replicate, shard_rays

__all__ = ["Mesh", "RAY_AXIS", "make_mesh", "replicate", "shard_rays"]
