"""Process groups: one process drives one GPU.

The counterpart of ``renderformer_tpu/parallel/distributed.py``, with the
environment contract of ``torchrun`` that the JAX function also honours:
``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
``LOCAL_RANK``, which picks the process's card.  On CUDA the group runs
NCCL, on the CPU (the tests) gloo.  A run with no such environment and no
arguments makes no group.  An init that fails raises: the group is checked
by one all-reduce before :func:`setup_distributed` returns, so a bad NCCL
setup fails there and not at the first step.

    torchrun --nproc_per_node=N -m renderformer_tpu_torch.train -c configs/config.yml
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def setup_distributed(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group that the arguments or torchrun's environment
    describe; returns whether a group is active.

    ``coordinator_address`` is ``host:port`` or an ``init_method`` URL
    (``tcp://...``, ``file://...``); ``device`` is ``'cuda'`` (the default:
    NCCL on the card ``LOCAL_RANK``, which must exist) or ``'cpu'`` (gloo).
    A world of 1 makes a group when the environment or the arguments name
    one, so that a one-card run goes through the same collectives."""
    if dist.is_initialized():
        return True
    if num_processes is None and 'WORLD_SIZE' in os.environ:
        num_processes = int(os.environ['WORLD_SIZE'])
        process_id = int(os.environ.get('RANK', 0))
    if num_processes is None:
        return False
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '12355')}")
    if '://' not in coordinator_address:
        coordinator_address = f'tcp://{coordinator_address}'
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available; pass device="cpu" for a gloo group')
        local = int(os.environ.get('LOCAL_RANK', 0)) if dev.index is None else dev.index
        torch.cuda.set_device(local)
        backend, probe_dev = 'nccl', torch.device('cuda', local)
    else:
        backend, probe_dev = 'gloo', torch.device('cpu')
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id or 0)
    probe = torch.ones(1, device=probe_dev)
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f'{backend} group: an all-reduce of ones gave {probe.item()}, '
                           f'not the world size {num_processes}')
    return True


def teardown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world():
    """(rank, world size) of the active group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_gather_cat(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim``, in rank
    order; ``x`` itself when ``n`` is 1."""
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def process_info() -> dict:
    """The JAX function's four keys: one process drives one device."""
    rank, world = rank_and_world()
    return {'process_index': rank, 'process_count': world, 'local_devices': 1,
            'global_devices': world}
