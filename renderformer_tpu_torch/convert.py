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
  * ``rope_freqs``                       <-> ``rope_emb.freqs`` (neither
    exists with ``pe_type='nerf'``, whose NeRF projections and norms are
    plain Linear and norm leaves)
  * DPT ``output_conv2.{conv1, conv2}``  <-> ``output_conv2.{0, 2}``

Both directions take numpy (or CPU torch) arrays and copy no value
bit-inexactly: the layout changes are transposes only.

On disk (``load_pretrained``, ``import_params``; the writer is
``training.checkpoint.export_params``) a checkpoint is a directory of
``config.json`` and ``model.safetensors``: an HF directory holds the
reference layout, which is the port's state_dict; one with a
``jax_format.json`` marker holds the JAX tree's leaves under dotted keys
(list items by index).

As a command line, an HF directory to an ``export_params`` directory,
which either package's ``from_pretrained`` loads:

    python -m renderformer_tpu_torch.convert <hf_dir> <out_dir>
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from renderformer_tpu_torch.config import RenderFormerConfig
from renderformer_tpu_torch.io import safetensors

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


def flatten_jax_params(tree, prefix: str = '') -> Dict[str, np.ndarray]:
    """A JAX parameter tree -> its leaves under dotted keys, as the JAX
    package's ``export_params`` names them (an empty item has no key)."""
    flat: Dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f'{prefix}.{k}' if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_jax_params(v, key))
        else:
            flat[key] = _np(v)
    return flat


def unflatten_jax_params(flat: Mapping) -> Dict:
    """Dotted keys -> the nested JAX tree (the JAX ``import_params`` rule)."""
    tree: Dict = {}
    for key, val in flat.items():
        _set(tree, tuple(key.split('.')), _np(val))
    return _listify(tree)


def load_pretrained(model_dir: str) -> Tuple[RenderFormerConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) of an HF directory: ``config.json`` and
    ``model.safetensors`` in the reference layout, which the port's modules
    carry, so no key changes.  The reference rotary embedding's ``dummy``
    device buffer is dropped, as the JAX converter drops it."""
    cfg = RenderFormerConfig.from_json(os.path.join(model_dir, 'config.json'))
    sd = safetensors.load_file(os.path.join(model_dir, 'model.safetensors'))
    return cfg, {k: v for k, v in sd.items() if k.split('.')[-1] != 'dummy'}


def import_params(model_dir: str) -> Tuple[RenderFormerConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) of a directory that either package's
    ``export_params`` wrote (``jax_format.json``: the JAX tree's leaves)."""
    cfg = RenderFormerConfig.from_json(os.path.join(model_dir, 'config.json'))
    flat = safetensors.load_file(os.path.join(model_dir, 'model.safetensors'))
    return cfg, jax_params_to_state_dict(unflatten_jax_params(flat))


def main(argv=None) -> int:
    import argparse
    from renderformer_tpu_torch.training.checkpoint import export_params
    parser = argparse.ArgumentParser(
        description='Convert a reference (HF) checkpoint to the export_params format')
    parser.add_argument('input_dir', help='HF dir with config.json + model.safetensors')
    parser.add_argument('output_dir', help='output dir (export_params format)')
    args = parser.parse_args(argv)
    cfg, sd = load_pretrained(args.input_dir)
    export_params(args.output_dir, sd, cfg)
    n = sum(v.numel() for v in sd.values() if v.is_floating_point())
    print(f'converted {n / 1e6:.1f}M params -> {args.output_dir}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
