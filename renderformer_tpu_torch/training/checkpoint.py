"""Save and restore a train state: parameters, optimizer state, step, and
``renderformer_meta.json`` with the model config and caller extras; and
export inference weights as a directory either package loads.

The counterpart of ``renderformer_tpu/training/checkpoint.py`` (which uses
orbax) with ``torch.save``: one ``state.pt`` under ``ckpt_dir/tag``.  The
compute-dtype shadow is not saved; it is rebuilt from the masters.

The port updates parameters and moments in place, so a save on another
thread takes :func:`snapshot`, host copies made before the next step, and
:func:`write_checkpoint` writes them; :func:`save_checkpoint` is both.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from renderformer_tpu_torch.config import RenderFormerConfig
from renderformer_tpu_torch.convert import flatten_jax_params, state_dict_to_jax_params
from renderformer_tpu_torch.io import safetensors
from renderformer_tpu_torch.training.state import TrainState, sync_shadow

STATE_FILE = 'state.pt'
META_FILE = 'renderformer_meta.json'


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies (a copy also of a tensor already on the host)."""
    return {n: t.detach().to('cpu', copy=True) for n, t in tensors.items()}


def snapshot(state: TrainState) -> Dict[str, Any]:
    """The state's parameters, optimizer state and step as host copies,
    finished when this returns: later in-place updates do not reach them."""
    opt = state.opt_state
    return {'params': _cpu(state.model.state_dict()),
            'opt_state': {'count': opt['count'], 'mu': _cpu(opt['mu']), 'nu': _cpu(opt['nu'])},
            'step': state.step}


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    model_config: RenderFormerConfig,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save under ``ckpt_dir/tag``, replacing what is there; returns the path."""
    return write_checkpoint(ckpt_dir, tag, snapshot(state), model_config, extra)


def write_checkpoint(ckpt_dir: str, tag: str, payload: Dict[str, Any],
                     model_config: RenderFormerConfig,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a :func:`snapshot` under ``ckpt_dir/tag``, replacing what is
    there; returns the path."""
    path = os.path.abspath(os.path.join(ckpt_dir, tag))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(payload, os.path.join(path, STATE_FILE))
    meta = {'model_config': model_config.to_dict(), 'extra': extra or {}}
    with open(os.path.join(path, META_FILE), 'w') as f:
        json.dump(meta, f, indent=2, default=float)
    return path


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into ``state`` in place (its tensors keep their devices and
    dtypes); returns it and the meta dict ({} if the file is missing)."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                         weights_only=True)
    state.model.load_state_dict(payload['params'])
    opt = payload['opt_state']
    for key in ('mu', 'nu'):
        for n, t in state.opt_state[key].items():
            t.copy_(opt[key][n])
    state.opt_state['count'] = int(opt['count'])
    state.step = int(payload['step'])
    if state.shadow is not None:
        sync_shadow(state)
    meta_path = os.path.join(path, META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def export_params(path: str, state_dict_or_model: Union[Mapping[str, torch.Tensor],
                                                        torch.nn.Module],
                  model_config: RenderFormerConfig) -> None:
    """Write inference weights as the JAX package's ``export_params`` does:
    ``config.json``, the ``jax_format.json`` marker and ``model.safetensors``
    with the JAX tree's leaves, so that either package's ``from_pretrained``
    loads the directory."""
    sd = (state_dict_or_model.state_dict() if isinstance(state_dict_or_model, torch.nn.Module)
          else state_dict_or_model)
    os.makedirs(path, exist_ok=True)
    model_config.save_json(os.path.join(path, 'config.json'))
    with open(os.path.join(path, 'jax_format.json'), 'w') as f:
        json.dump({'format': 'renderformer_tpu', 'version': 1}, f)
    safetensors.save_file(flatten_jax_params(state_dict_to_jax_params(sd)),
                          os.path.join(path, 'model.safetensors'))
