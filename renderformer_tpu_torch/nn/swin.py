"""Swin window helpers: window partition and order, the plain shifted-window
regroup, and the shifted-window mask.

The view decoder of a Swin model keeps its residual stream ``[B, S, C]`` in
unshifted-window order (:func:`seq_to_window_order`): an unshifted layer
then windows with a reshape, and a shifted layer regroups the stream into
shifted-window order and back (:func:`shifted_regroup`, kernel K7 on the
card).  The windows of a shifted layer attend under :func:`swin_attn_mask`,
which is the equality of the region labels of :func:`swin_regions`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x, window_size: int):
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def window_order_indices(h: int, w: int, window_size: int) -> np.ndarray:
    """The permutation of :func:`seq_to_window_order` as indices:
    out[i] = seq[idx[i]]."""
    ws = window_size
    idx = np.arange(h * w).reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(idx.reshape(-1))


def seq_to_window_order(x, h: int, w: int, ws: int):
    """[B, h*w, ...] row-major -> unshifted-window order, one permute copy;
    the dims after the sequence axis are kept."""
    b, trail = x.shape[0], tuple(x.shape[2:])
    c = int(np.prod(trail)) if trail else 1
    return window_partition(x.reshape(b, h, w, c), ws).reshape((b, h * w) + trail)


def seq_from_window_order(x, h: int, w: int, ws: int):
    """Inverse of :func:`seq_to_window_order`."""
    b, s, trail = x.shape[0], x.shape[1], tuple(x.shape[2:])
    c = int(np.prod(trail)) if trail else 1
    return window_reverse(x.reshape(-1, ws * ws, c), ws, h, w).reshape((b, s) + trail)


def _roll_windowed_axis(x6, wdim: int, idim: int, s: int, ws: int):
    """Roll a spatial axis by -s on the window-ordered 6-D view
    [B, Wr, Wc, ir, ic, C], the axis split into (window ``wdim``,
    in-window ``idim``): out[.., w, .., i, ..] = x[row w*ws + i + s]."""
    lead = x6.narrow(idim, s, ws - s)
    wrap = torch.roll(x6.narrow(idim, 0, s), -1, dims=wdim)
    return torch.cat([lead, wrap], dim=idim)


def _unroll_windowed_axis(x6, wdim: int, idim: int, s: int, ws: int):
    """Inverse of :func:`_roll_windowed_axis` (roll by +s)."""
    lead = torch.roll(x6.narrow(idim, ws - s, s), 1, dims=wdim)
    rest = x6.narrow(idim, 0, ws - s)
    return torch.cat([lead, rest], dim=idim)


def shifted_regroup(x, h: int, w: int, ws: int, s: int, inverse: bool = False):
    """Regroup a window-ordered stream [B, S, C] into shifted-window order
    (the grouping of partition(roll(x, -s))), or back when ``inverse``, by
    slice, roll and concat."""
    b, _, c = x.shape
    x6 = x.reshape(b, h // ws, w // ws, ws, ws, c)
    if inverse:
        x6 = _unroll_windowed_axis(x6, 1, 3, s, ws)
        x6 = _unroll_windowed_axis(x6, 2, 4, s, ws)
    else:
        x6 = _roll_windowed_axis(x6, 1, 3, s, ws)
        x6 = _roll_windowed_axis(x6, 2, 4, s, ws)
    return x6.reshape(b, h * w, c)


@functools.lru_cache(maxsize=64)
def swin_regions(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """[nW, ws*ws] uint8 region label of each token of each shifted window:
    the nine bands of the rolled image, in window order."""
    img = np.zeros((h, w), dtype=np.uint8)
    bands = (slice(0, -window_size), slice(-window_size, -shift_size),
             slice(-shift_size, None))
    cnt = 0
    for hs in bands:
        for wsl in bands:
            img[hs, wsl] = cnt
            cnt += 1
    ws = window_size
    img = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(img.reshape(-1, ws * ws))


@functools.lru_cache(maxsize=64)
def swin_attn_mask(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """[nW, ws*ws, ws*ws] bool attend-mask of the shifted windows: token i
    attends to token j when both lie in the same region."""
    reg = swin_regions(h, w, window_size, shift_size)
    return reg[:, None, :] == reg[:, :, None]
