"""The device mesh: a process group of torch.distributed.

Counterpart of zkarray/dist/mesh.py, where a mesh is a jax.sharding.Mesh
with named axes and XLA's collectives run over it. Here each device is one
process (one rank), the collectives are torch.distributed's (NCCL between
CUDA cards, gloo between CPU processes), and a mesh is a small value naming
the group, its size, this process's rank and the axis. The caller brings the
group up (``torch.distributed.init_process_group`` with its address, world
size and rank) before making a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks of ``group`` (None: the default group)
    along the axis ``axis``; ``rank`` is this process's index on it."""
    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    axis: str = "shards"

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


@dataclass(frozen=True)
class Mesh2D:
    """A 2-D mesh over one group: rank = coords[0] * shape[1] + coords[1]."""
    group: Optional[dist.ProcessGroup]
    dims: Tuple[int, int]
    rank: int
    axes: Tuple[str, str] = ("hosts", "chips")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.dims))

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.dims[1])


def _group_size_rank(group):
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise torch.distributed first (init_process_group)")
    return dist.get_world_size(group), dist.get_rank(group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "shards", group=None) -> Mesh:
    """1-D mesh over the process group (the default one unless given).
    ``n_devices``, when given, must be the group's size: a rank cannot
    leave the collectives of its own group."""
    size, rank = _group_size_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {size} ranks")
    return Mesh(group, size, rank, axis)


def make_mesh_2d(shape: Sequence[int], axes=("hosts", "chips"), group=None) -> Mesh2D:
    """2-D mesh of ``shape`` (rows, cols) over the group's ranks, row-major."""
    size, rank = _group_size_rank(group)
    dims = (int(shape[0]), int(shape[1]))
    if dims[0] * dims[1] != size:
        raise ValueError(f"make_mesh_2d: {dims} needs {dims[0] * dims[1]} ranks, the group has {size}")
    return Mesh2D(group, dims, rank, tuple(axes))
