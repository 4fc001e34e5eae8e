"""Generic dict <-> H5 (de)serialization and scene JSON <-> H5 bridges (the
JAX package's ``scene/h5_tools.py``, the reference implementation's
``scene_processor/h5_tools.py`` without its dacite dependency).

Files are read and written through the port's HDF5 codec, ``io/hdf5.py``:
no ``h5py`` is needed.  It reads the files h5py writes too, whose strings
are variable-length (the port writes them fixed-length); both read back as
``bytes``.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from renderformer_tpu_torch.io import hdf5
from renderformer_tpu_torch.scene.scene_config import scene_config_from_dict


def _write_dict_to_group(group, data: Dict[str, Any]) -> None:
    for key, value in data.items():
        if isinstance(value, dict):
            sub = group.create_group(key)
            _write_dict_to_group(sub, value)
        elif isinstance(value, (list, tuple)):
            arr = np.asarray(value)
            if arr.dtype.kind in 'OU':
                group.create_dataset(
                    key, data=json.dumps(value).encode())
                group[key].attrs['__json__'] = True
            else:
                group.create_dataset(key, data=arr)
        elif isinstance(value, str):
            group.create_dataset(key, data=value.encode())
        elif value is None:
            group.create_dataset(key, data=b'__none__')
        else:
            group.create_dataset(key, data=value)


def save_dict_to_h5(data: Dict[str, Any], h5_path: str) -> None:
    with hdf5.File(h5_path, 'w') as f:
        _write_dict_to_group(f, data)


def _read_group_to_dict(group) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, item in group.items():
        if isinstance(item, hdf5.Group):
            out[key] = _read_group_to_dict(item)
        else:
            val = item[()]
            if isinstance(val, bytes):
                if val == b'__none__':
                    out[key] = None
                elif item.attrs.get('__json__'):
                    out[key] = json.loads(val.decode())
                else:
                    out[key] = val.decode()
            elif isinstance(val, np.ndarray):
                out[key] = val.tolist()
            else:
                out[key] = val.item() if np.isscalar(val) else val
    return out


def load_dict_from_h5(h5_path: str) -> Dict[str, Any]:
    with hdf5.File(h5_path, 'r') as f:
        return _read_group_to_dict(f)


def save_dict_to_h5_renderformer_method(data: Dict[str, Any],
                                        h5_path: str,
                                        scene_config_dir: str = '') -> None:
    """Scene dict -> meshes -> model-ready H5 (the reference's
    ``h5_tools.py``)."""
    from renderformer_tpu_torch.scene.scene_mesh import generate_scene_meshes
    from renderformer_tpu_torch.scene.to_h5 import save_to_h5
    cfg = scene_config_from_dict(data)
    meshes = generate_scene_meshes(cfg, scene_config_dir)
    save_to_h5(cfg, meshes, str(h5_path))



def json_to_h5(json_path: str, h5_path: str) -> None:
    with open(json_path) as f:
        save_dict_to_h5(json.load(f), h5_path)


def h5_to_json(h5_path: str, json_path: str) -> None:
    with open(json_path, 'w') as f:
        json.dump(load_dict_from_h5(h5_path), f, indent=4)
