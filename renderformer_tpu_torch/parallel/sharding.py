"""The (data, seq) mesh and the context that turns sequence parallelism on.

The counterpart of ``renderformer_tpu/parallel/sharding.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with
axes ``('data', 'seq')``: scenes split over ``data`` (each rank renders or
trains on its own scenes), the attention sites over ``seq``.  Inside
:func:`use_sharding`, ``nn/attention.py``'s full attention sites split
over the mesh's ``seq`` ranks (``parallel/ring_attention.py``): by ring
attention where both sequence lengths divide the axis, else by
sequence-split attention where the query length does.

``constrain``, ``input_sharding`` and ``replicated`` have no counterpart:
JAX places global arrays on the mesh and XLA partitions the program,
while here each rank holds its own data shard by construction (its slice of
the batch, from the pipeline or the dataset), the parameters whole, and
the attention sites do their collectives themselves.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    'renderformer_tpu_torch_sharding', default=None)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ('data', 'seq')) -> DeviceMesh:
    """A mesh over the group's ranks (row-major); ``shape`` defaults to
    every rank on ``data``.  Without a group, a mesh of one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(f'mesh {shape} over axes {tuple(axis_names)} does not hold the '
                         f'{world} ranks of the group')
    ranks = torch.arange(world).reshape(shape)
    if not dist.is_initialized():
        return DeviceMesh('cpu', ranks, mesh_dim_names=tuple(axis_names),
                          _init_backend=False, _rank=0)
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Ranks along axis ``name`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along axis ``name``."""
    names = mesh.mesh_dim_names
    return mesh.get_coordinate()[names.index(name)] if name in names else 0


def axis_ranks(mesh: DeviceMesh, name: str) -> list:
    """Global ranks of this rank's group along axis ``name``, in axis order."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(name)] = slice(None)
    return mesh.mesh[tuple(coord)].tolist()


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of this rank's ranks along axis ``name``."""
    return mesh.get_group(name)


@contextlib.contextmanager
def use_sharding(mesh: DeviceMesh):
    """Split the full attention sites called inside the block over
    ``mesh``'s ``seq`` axis (the module docstring says how)."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE.get()


def current_sharding():
    """The active context as a value, to re-enter with
    :func:`restored_sharding` where this one is not visible: a remat
    recomputation, which autograd may run on a thread of its own."""
    return _ACTIVE.get()


@contextlib.contextmanager
def restored_sharding(state):
    """Re-enter a context that :func:`current_sharding` returned."""
    token = _ACTIVE.set(state)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
