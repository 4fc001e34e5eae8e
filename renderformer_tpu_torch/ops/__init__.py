"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

A wrapper takes the plain version for a tensor on the CPU.  For a CUDA
tensor it launches its kernel, or raises; the one way to run the plain
versions on CUDA tensors is :func:`reference_kernels`, which the kernel
checks enter and the main path never does.

Every kernel launch adds one to its entry in :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES = {
    'flash_fwd_rope_mask': 0,
    'flash_fwd_rope_nomask': 0,
    'rot_kv_broadcast': 0,
    'resize_bilinear': 0,
}

_plain_on_cuda = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def reference_kernels():
    """Run the plain PyTorch versions in place of the kernels, also on
    CUDA tensors."""
    global _plain_on_cuda
    prev = _plain_on_cuda
    _plain_on_cuda = True
    try:
        yield
    finally:
        _plain_on_cuda = prev


def use_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'no kernel for device {t.device}')
    return _plain_on_cuda


def check_no_grad(*tensors) -> None:
    """The kernels are forward-only: refuse inputs that autograd tracks."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            'the port\'s kernels are forward-only; call under '
            'torch.no_grad() or torch.inference_mode()')


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned CUDA tensor of
    ``dtype`` and ``shape``."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
    if t.data_ptr() % 16:
        raise ValueError(f'{name}: expected a 16-byte aligned tensor')
