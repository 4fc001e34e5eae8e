"""JSON scene -> H5 conversion CLI (the JAX package's
``scene/convert_scene.py``, the reference implementation's
``scene_processor/convert_scene.py``); the H5 file is written by the port's
``io/hdf5`` (no ``h5py``):
    python -m renderformer_tpu_torch.scene.convert_scene scene.json out.h5
"""

from __future__ import annotations

import argparse
import os

from renderformer_tpu_torch.scene.scene_config import load_scene_config
from renderformer_tpu_torch.scene.scene_mesh import generate_scene_meshes
from renderformer_tpu_torch.scene.to_h5 import save_to_h5


def convert_scene(json_path: str, h5_path: str) -> None:
    cfg = load_scene_config(json_path)
    meshes = generate_scene_meshes(cfg, os.path.dirname(
        os.path.abspath(json_path)))
    tensors = save_to_h5(cfg, meshes, h5_path)
    print(f'{cfg.scene_name}: {tensors["triangles"].shape[0]} triangles, '
          f'{tensors["c2w"].shape[0]} cameras -> {h5_path}')


def main(argv=None):
    parser = argparse.ArgumentParser(description='Convert scene JSON to H5')
    parser.add_argument('json_file', type=str)
    parser.add_argument('output_h5', type=str)
    args = parser.parse_args(argv)
    convert_scene(args.json_file, args.output_h5)


if __name__ == '__main__':
    main()
