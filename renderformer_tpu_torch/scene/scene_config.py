"""Scene JSON schema (the JAX package's ``scene/scene_config.py``): the
reference implementation's ``scene_processor/scene_config.py``, with a
built-in strict dict loader in place of its dacite dependency."""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class TransformConfig:
    translation: List[float]
    rotation: List[float]          # degrees, applied x then y then z
    scale: List[float]
    normalize: bool = True


@dataclass
class MaterialConfig:
    diffuse: List[float]
    specular: List[float]
    roughness: float
    emissive: List[float]
    smooth_shading: bool
    rand_tri_diffuse_seed: Optional[int] = None
    random_diffuse_max: float = 1.0
    random_diffuse_type: str = 'per-shading-group'  # | 'per-triangle'


@dataclass
class ObjectConfig:
    mesh_path: str
    material: MaterialConfig
    transform: TransformConfig
    remesh: bool = False
    remesh_target_face_num: int = 2048


@dataclass
class CameraConfig:
    position: List[float]
    look_at: List[float]
    up: List[float]
    fov: float


@dataclass
class SceneConfig:
    scene_name: str
    version: str
    objects: Dict[str, ObjectConfig]
    cameras: List[CameraConfig]


def _from_dict(cls, data):
    """Strict nested-dataclass construction (dacite.from_dict equivalent:
    unknown keys raise, missing required keys raise)."""
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            raise TypeError(f'expected dict for {cls.__name__}, got {type(data)}')
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(data) - set(fields)
        if unknown:
            raise ValueError(f'unknown keys for {cls.__name__}: {sorted(unknown)}')
        kwargs = {}
        hints = typing.get_type_hints(cls)
        for name, f in fields.items():
            if name in data:
                kwargs[name] = _from_dict(hints[name], data[name])
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                raise ValueError(f'missing key {name!r} for {cls.__name__}')
        return cls(**kwargs)

    origin = typing.get_origin(cls)
    if origin in (list, List):
        (item_t,) = typing.get_args(cls)
        return [_from_dict(item_t, x) for x in data]
    if origin in (dict, Dict):
        _, val_t = typing.get_args(cls)
        return {k: _from_dict(val_t, v) for k, v in data.items()}
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(cls) if a is not type(None)]
        if data is None:
            return None
        return _from_dict(args[0], data)
    return data


def load_scene_config(path: str) -> SceneConfig:
    with open(path) as f:
        return _from_dict(SceneConfig, json.load(f))


def scene_config_from_dict(d: dict) -> SceneConfig:
    return _from_dict(SceneConfig, d)


def scene_config_to_dict(cfg: SceneConfig) -> dict:
    return dataclasses.asdict(cfg)


def save_scene_config(path: str, cfg: SceneConfig) -> None:
    with open(path, 'w') as f:
        json.dump(scene_config_to_dict(cfg), f, indent=2)
