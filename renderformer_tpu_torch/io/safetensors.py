"""Reader and writer of the safetensors format, in numpy and torch.

The layout (the format's public specification): an 8-byte little-endian
header length N; N bytes of JSON mapping each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}``, with an optional
``"__metadata__"`` map of strings; then the raw little-endian buffer, the
offsets relative to its start.  The reader holds the offsets to the rule:
sorted, they must run contiguously from 0 to the end of the buffer, each
span the size its dtype and shape give; anything else raises.

The file is read through ``numpy.memmap``, each tensor copied once into
memory of its own, so a file is never held twice and every loaded tensor
is writeable.  The writer orders tensors by element size, largest first,
then by name, and pads the header with spaces to a multiple of 8 bytes, as
the reference implementation does, so every tensor lies aligned.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {'F32': torch.float32, 'F16': torch.float16, 'BF16': torch.bfloat16,
          'I64': torch.int64, 'I32': torch.int32, 'BOOL': torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


def _read_header(f, file_size: int) -> Tuple[dict, Optional[dict], int]:
    """(entries, metadata, buffer start) of an open file, offsets checked."""
    if file_size < 8:
        raise ValueError(f'{file_size}-byte file is too short for a safetensors header')
    n, = struct.unpack('<Q', f.read(8))
    if n > min(file_size - 8, _MAX_HEADER):
        raise ValueError(f'header length {n} exceeds the file ({file_size} bytes)')
    header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError('safetensors header is not a JSON object')
    meta = header.pop('__metadata__', None)
    buf_size = file_size - 8 - n
    spans = []
    for name, e in header.items():
        if not isinstance(e, dict) or e.get('dtype') not in DTYPES:
            raise ValueError(f'{name}: not an entry of a supported dtype: {e!r}')
        shape, offs = e.get('shape'), e.get('data_offsets')
        if (not isinstance(shape, list) or not all(isinstance(s, int) and s >= 0 for s in shape)
                or not isinstance(offs, list) or len(offs) != 2
                or not all(isinstance(o, int) for o in offs)):
            raise ValueError(f'{name}: malformed shape {shape!r} or data_offsets {offs!r}')
        spans.append((offs[0], offs[1], name))
    pos = 0
    for begin, end, name in sorted(spans):
        e = header[name]
        size = int(np.prod(e['shape'], dtype=np.int64)) * DTYPES[e['dtype']].itemsize
        if begin != pos or end - begin != size:
            raise ValueError(f'{name}: data_offsets [{begin}, {end}] are not the next '
                             f'{size} bytes from {pos}')
        pos = end
    if pos != buf_size:
        raise ValueError(f'tensors cover {pos} of the {buf_size}-byte buffer')
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file, as CPU tensors that own their memory."""
    file_size = os.path.getsize(path)
    with open(path, 'rb') as f:
        header, _, start = _read_header(f, file_size)
    mm = (np.memmap(path, np.uint8, 'r', offset=start, shape=(file_size - start,))
          if file_size > start else None)
    out = {}
    for name, e in sorted(header.items(), key=lambda kv: kv[1]['data_offsets']):
        t = torch.empty(e['shape'], dtype=DTYPES[e['dtype']])
        if t.numel():
            begin, end = e['data_offsets']
            t.reshape(-1).view(torch.uint8).numpy()[:] = mm[begin:end]
        out[name] = t
    del mm
    return out


def load_metadata(path: str) -> Optional[Dict[str, str]]:
    """The header's ``__metadata__`` map, or None."""
    with open(path, 'rb') as f:
        return _read_header(f, os.path.getsize(path))[1]


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write tensors or numpy arrays (any device; bf16 only as a tensor)."""
    items = []
    for name, x in tensors.items():
        t = (x.detach().cpu() if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(x)))
        if t.dtype not in _NAMES:
            raise ValueError(f'{name}: dtype {t.dtype} has no safetensors name')
        items.append((name, t.contiguous()))
    items.sort(key=lambda it: (-it[1].element_size(), it[0]))
    header, pos = {}, 0
    if metadata is not None:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError('safetensors metadata maps strings to strings')
        header['__metadata__'] = dict(metadata)
    for name, t in items:
        size = t.numel() * t.element_size()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [pos, pos + size]}
        pos += size
    blob = json.dumps(header, separators=(',', ':')).encode()
    blob += b' ' * (-len(blob) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
