"""Weight bridge between the JAX parameter tree and the port's state_dict.

The port's modules carry the reference's torch layout and key names, so
this is the JAX converter's rules run backwards (and forwards, for the
round trip), classified by tensor rank:

  * rank-2 Linear ``kernel [in, out]``   <-> ``weight [out, in]``
  * rank-1 norm ``scale``                <-> ``weight``; ``bias`` <-> ``bias``
  * rank-4 Conv2d HWIO                   <-> OIHW
  * rank-4 ConvTranspose2d ``[kh, kw, I, O]`` <-> ``[I, O, kh, kw]``
    (only ``resize_layers.0`` / ``resize_layers.1``)
  * rank-3 learned tokens                kept as they are
  * ``rope_freqs``                       <-> ``rope_emb.freqs``
  * DPT ``output_conv2.{conv1, conv2}``  <-> ``output_conv2.{0, 2}``

Both directions take numpy (or CPU torch) arrays and copy no value
bit-inexactly: the layout changes are transposes only.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CONVT = ('resize_layers.0', 'resize_layers.1')
_SEQ_OUT = {'conv1': '0', 'conv2': '2'}
_SEQ_IN = {v: k for k, v in _SEQ_OUT.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(node, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f'{prefix}{i}.', out)
        return
    for k, v in node.items():
        if isinstance(v, (dict, list, tuple)):
            if prefix.endswith('output_conv2.') and k in _SEQ_OUT:
                k = _SEQ_OUT[k]
            _flatten(v, f'{prefix}{k}.', out)
            continue
        v = _np(v)
        module = prefix[:-1]
        if k == 'rope_freqs':
            out[f'{prefix}rope_emb.freqs'] = v
        elif k == 'kernel' and v.ndim == 4:
            if module.endswith(_CONVT):
                out[f'{prefix}weight'] = np.ascontiguousarray(
                    v.transpose(2, 3, 0, 1))
            else:
                out[f'{prefix}weight'] = np.ascontiguousarray(
                    v.transpose(3, 2, 0, 1))
        elif k == 'kernel' and v.ndim == 2:
            out[f'{prefix}weight'] = np.ascontiguousarray(v.T)
        elif k == 'scale':
            out[f'{prefix}weight'] = v
        elif k == 'bias' or v.ndim == 3:
            out[f'{prefix}{k}'] = v
        else:
            raise ValueError(f'unexpected leaf {prefix}{k}: {v.shape}')


def jax_params_to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """Nested JAX parameter tree (numpy leaves) -> reference-layout
    state_dict of CPU torch tensors, ready for ``load_state_dict``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, '', flat)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _set(tree: dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _listify(node):
    """{'0': .., '1': ..} children (ModuleLists) -> lists; a missing index
    (``resize_layers.2`` is an Identity) becomes ``{}``."""
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        v = _listify(v)
        if isinstance(v, dict) and v and all(kk.isdigit() for kk in v):
            v = [v.get(str(i), {}) for i in range(max(int(kk) for kk in v) + 1)]
        out[k] = v
    return out


def state_dict_to_jax_params(state_dict: Mapping) -> Dict:
    """Reference-layout state_dict -> nested JAX parameter tree (numpy)."""
    tree: Dict = {}
    for key, val in state_dict.items():
        value = _np(val)
        parts = key.split('.')
        name = parts[-1]
        if parts[-2:] == ['rope_emb', 'freqs']:
            _set(tree, tuple(parts[:-2]) + ('rope_freqs',), value)
            continue
        if name == 'dummy':
            continue
        if len(parts) >= 3 and parts[-3] == 'output_conv2':
            parts = parts[:-2] + [_SEQ_IN[parts[-2]], name]
        path = tuple(parts[:-1])
        if value.ndim == 4:
            if '.'.join(parts[-3:-1]) in _CONVT:
                kernel = value.transpose(2, 3, 0, 1)
            else:
                kernel = value.transpose(2, 3, 1, 0)
            _set(tree, path + ('kernel',), np.ascontiguousarray(kernel))
        elif value.ndim == 3:
            _set(tree, tuple(parts), value)
        elif value.ndim == 2:
            _set(tree, path + ('kernel',), np.ascontiguousarray(value.T))
        elif value.ndim == 1:
            _set(tree, path + ('scale' if name == 'weight' else 'bias',), value)
        else:
            raise ValueError(f'unexpected tensor rank for {key}: {value.shape}')
    return _listify(tree)
