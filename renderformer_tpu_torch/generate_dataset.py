"""Random-scene dataset generator (Cornell-box variations; the JAX package's
``generate_dataset.py``).

    python -m renderformer_tpu_torch.generate_dataset --data_path datasets \
        --num_scenes 10 --gt_mode pathtrace [--gt_resolution 256] [--gt_spp 64] \
        [--seed 0] [--cpu]

Randomized object pose, roughness, light height and fov inside a
Cornell-box template (the reference implementation's
``generate_dataset.py``), written as scene JSONs and H5 files under
``<data_path>/json`` and ``<data_path>/h5``, and a ground-truth PNG a scene
under ``<data_path>/gt``.  The same ``--seed`` gives the same scene JSONs
as the JAX script: the draws are made in its order, the H5 conversion
(which reseeds Python's generator with each ``rand_tri_diffuse_seed``)
between one scene's draws and the next, as there.  Mesh paths are
relative to the working directory, the repository's root.

GT sources (``--gt_mode``):

  * ``pathtrace`` -- the port's path tracer (``scene/path_tracer.py``) on
    the card, ``--gt_spp`` samples a pixel, clamp 10;
  * ``model``     -- the port's pipeline in fp32 (``--gt_preset``: ``tiny``,
    a CI-scale model of head dim 128, or a preset, with seeded weights; or
    ``--gt_checkpoint`` through ``RenderingPipeline.from_pretrained``);
  * ``raster``    -- the flat debug rasterizer (``render_h5_to_png``);
  * ``blender``   -- a blenderproc subprocess (``scene/render_scene.py``),
    a warning where it is not installed;
  * ``none``      -- scenes only;
  * ``auto``      -- blender where available, else raster.

``pathtrace`` and ``model`` run on the card unless ``--cpu`` is given.
The GT pass (``render_gt``) takes scene dicts; the H5 files are read
only by ``render_gt_batch``, at its edge, and written, both through the
port's ``io/hdf5`` (no ``h5py``).
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import random
import shutil
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np

CONFIG = {
    'DATA_PATH': 'datasets',
    'JSON_PATH': 'datasets/json',
    'H5_PATH': 'datasets/h5',
    'GT_PATH': 'datasets/gt',
    'OBJ_PATH': 'examples/objects',
    'BASE_DIR': 'examples',
    'SCRIPT_NAME': 'render_scene.py',
    'NUM_RANDOM_SCENES': 10,
    'MAX_CONCURRENT_TASKS': 4,
    'GT_MODE': 'auto',          # blender | model | raster | pathtrace | none | auto
    'GT_RESOLUTION': 256,
    'GT_PRESET': 'v1-base',     # for GT_MODE=model
    'GT_CHECKPOINT': None,      # local checkpoint dir; None -> seeded init
    'GT_SPP': 64,
    'GT_SEED': 0,
    'DEVICE': None,             # None -> cuda
}
GT_RENDERERS = ('model', 'raster', 'pathtrace')
PATHTRACE_CLAMP = 10.0  # firefly clamp for LDR-clipped GT (slightly biased)

# the CI-scale GT model of gt_preset='tiny': the JAX script's depths and DPT
# widths, one head of 128 (the only head dim the port's attention kernels
# take, the released models'; the JAX script's two heads of 36 would raise
# on the card)
TINY = dict(latent_dim=128, num_layers=2, num_heads=1, dim_feedforward=256,
            num_register_tokens=4, vertex_pe_num_freqs=4, view_transformer_latent_dim=128,
            view_transformer_ffn_hidden_dim=256, view_transformer_n_heads=1,
            view_transformer_n_layers=4, dpt_features=16, dpt_out_channels=[8, 16, 32, 64])


def _bg(mesh: str, diffuse, emissive=(0.0, 0.0, 0.0)) -> Dict:
    return {
        'mesh_path': mesh,
        'transform': {'translation': [0.0, 0.0, 0.0],
                      'rotation': [0.0, 0.0, 0.0],
                      'scale': [0.5, 0.5, 0.5], 'normalize': False},
        'material': {'diffuse': list(diffuse),
                     'specular': [0.01, 0.01, 0.01],
                     'random_diffuse_max': 0.4, 'roughness': 0.99,
                     'emissive': list(emissive), 'smooth_shading': True,
                     'rand_tri_diffuse_seed': None},
    }


def scene_tensors(scene: Dict, scene_config_dir: str = '') -> Dict[str, np.ndarray]:
    """A scene dict converted in memory, in ``io/h5.load_scene_h5``'s layout
    (``triangles``, ``texture``, ``mask``, ``vn``, ``c2w``, ``fov``), with the
    same arrays as its H5 file read back."""
    from renderformer_tpu_torch.io.h5 import pad_scene
    from renderformer_tpu_torch.scene.scene_config import scene_config_from_dict
    from renderformer_tpu_torch.scene.scene_mesh import generate_scene_meshes
    from renderformer_tpu_torch.scene.to_h5 import scene_to_tensors
    cfg = scene_config_from_dict(scene)
    tensors = scene_to_tensors(cfg, generate_scene_meshes(cfg, scene_config_dir))
    # the H5 file stores the texture in float16
    tensors['texture'] = tensors['texture'].astype(np.float16)
    return pad_scene(tensors)


def gt_pipeline(preset: str = 'v1-base', checkpoint: Optional[str] = None, seed: int = 0,
                device=None):
    """The GT model of ``gt_mode='model'``: a local checkpoint, else
    ``preset`` (``'tiny'`` or a name of PRESETS) with seeded weights."""
    from renderformer_tpu_torch import PRESETS, RenderFormerConfig, RenderingPipeline
    if checkpoint:
        return RenderingPipeline.from_pretrained(checkpoint, device=device)
    cfg = RenderFormerConfig(**TINY) if preset == 'tiny' else PRESETS[preset]
    return RenderingPipeline.from_config(cfg, seed=seed, device=device)


def render_gt(scenes: Mapping[str, Mapping[str, np.ndarray]], mode: str, gt_dir: str,
              resolution: int = 256, spp: int = 64, seed: int = 0, preset: str = 'v1-base',
              checkpoint: Optional[str] = None, device=None) -> Dict[str, np.ndarray]:
    """Write ``<gt_dir>/<name>.png`` of view 0 of each scene dict (in
    ``load_scene_h5``'s layout) by ``mode`` (one of GT_RENDERERS); returns
    the uint8 images by name.  ``pathtrace`` and ``model`` run on
    ``device``: ``cuda`` unless the caller asks for the CPU."""
    from renderformer_tpu_torch.io.image import write_png
    if mode not in GT_RENDERERS:
        raise ValueError(f'gt mode {mode!r} renders in no GT pass (one of {GT_RENDERERS})')
    if mode == 'model':
        pipe = gt_pipeline(preset, checkpoint, seed, device)
        label = f'model/{checkpoint or preset}'
    elif mode == 'pathtrace':
        label = f'pathtrace spp={spp}'
    else:
        label = 'raster'
    out = {}
    for name, data in scenes.items():
        if mode == 'pathtrace':
            from renderformer_tpu_torch.scene.path_tracer import render_scene_pathtrace
            img = render_scene_pathtrace(data, view=0, resolution=resolution, spp=spp,
                                         seed=seed, clamp=PATHTRACE_CLAMP, device=device)
        elif mode == 'raster':
            from renderformer_tpu_torch.render_h5_to_png import debug_render
            img = debug_render(data, view=0, resolution=resolution)
        else:
            img = pipe.render(
                data['triangles'][None], data['texture'][None], data['mask'][None],
                data['vn'][None], data['c2w'][None], data['fov'][None, :, None],
                resolution=resolution, precision='fp32',
                view_precision='fp32')[0, 0].cpu().numpy()
        out[name] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(gt_dir, f'{name}.png'), out[name])
        print(f'GT ({label}) {name}.png')
    return out


class SceneGenerator:
    def __init__(self, config: dict):
        self.config = config
        self.objects_path = Path(config['OBJ_PATH'])
        self.json_path = Path(config['JSON_PATH'])
        self.h5_path = Path(config['H5_PATH'])
        self.gt_path = Path(config['GT_PATH'])
        for p in (self.json_path, self.h5_path, self.gt_path):
            p.mkdir(parents=True, exist_ok=True)
        self.available_objects = self._collect_objects()
        mode = config.get('GT_MODE', 'auto')
        if mode == 'auto':
            mode = 'blender' if shutil.which('blenderproc') else 'raster'
        self.gt_mode = mode

    def _collect_objects(self) -> List[tuple]:
        # glob's order, as the JAX script takes it: random.choice draws from it
        objects = []
        for obj_file in glob.glob(str(self.objects_path / '**/*.obj'), recursive=True):
            rel = os.path.relpath(obj_file, str(self.objects_path))
            objects.append((Path(rel).stem, rel))
        return objects

    # ------------------------------------------------------------------
    def generate_scene(self, scene_name: str, object_name: str, object_path: str) -> Dict:
        """Randomized Cornell-box scene: random object pose, scale and
        roughness, light height 1.5-2.5, fov 30-60 deg."""
        base = self.config['BASE_DIR']
        return {
            'scene_name': scene_name,
            'version': '1.0',
            'objects': {
                'background_0': _bg(f'{base}/templates/backgrounds/plane.obj',
                                    [0.4, 0.4, 0.4]),
                'background_1': _bg(f'{base}/templates/backgrounds/wall0.obj',
                                    [0.4, 0.4, 0.4]),
                'background_2': _bg(f'{base}/templates/backgrounds/wall1.obj',
                                    [0.1, 0.4, 0.1]),
                'background_3': _bg(f'{base}/templates/backgrounds/wall2.obj',
                                    [0.4, 0.1, 0.1]),
                'object_0': {
                    'mesh_path': f'{self.config["OBJ_PATH"]}/{object_path}',
                    'transform': {
                        'translation': [random.uniform(-0.3, 0.3),
                                        random.uniform(-0.3, 0.3),
                                        random.uniform(-0.3, 0.3)],
                        'rotation': [random.uniform(0, 360) for _ in range(3)],
                        'scale': [random.uniform(0.4, 0.8) for _ in range(3)],
                        'normalize': True,
                    },
                    'material': {
                        'diffuse': [0.5, 0.5, 0.5],
                        'specular': [0.5, 0.5, 0.5],
                        'random_diffuse_max': 0.5,
                        'roughness': random.uniform(0.001, 1.0),
                        'emissive': [0.0, 0.0, 0.0],
                        'smooth_shading': True,
                        'rand_tri_diffuse_seed': random.randint(0, 2 ** 31),
                    },
                },
                'light_0': {
                    'mesh_path': f'{base}/templates/lighting/tri.obj',
                    'transform': {
                        'translation': [0.0, 0.0, random.uniform(1.5, 2.5)],
                        'rotation': [0.0, 0.0, 0.0],
                        'scale': [2.5, 2.5, 2.5],
                        'normalize': False,
                    },
                    'material': {
                        'diffuse': [1.0, 1.0, 1.0],
                        'specular': [0.0, 0.0, 0.0],
                        'random_diffuse_max': 0.0,
                        'roughness': 1.0,
                        'emissive': [5000.0, 5000.0, 5000.0],
                        'smooth_shading': True,
                        'rand_tri_diffuse_seed': None,
                    },
                },
            },
            'cameras': [{
                'position': [0.0, -2.0, 0.0],
                'look_at': [0.0, 0.0, 0.0],
                'up': [0.0, 0.0, 1.0],
                'fov': random.uniform(30, 60),
            }],
        }

    def next_scene(self, scene_index: int):
        """The name and dict of scene ``scene_index``, drawn from Python's
        global generator as the JAX script draws it."""
        obj_name, obj_path = random.choice(self.available_objects)
        name = f'random_scene_{scene_index}_{obj_name}'
        return name, self.generate_scene(name, obj_name, obj_path)

    # ------------------------------------------------------------------
    async def save_scene_async(self, scene: Dict, scene_name: str):
        json_file = self.json_path / f'{scene_name}.json'
        with open(json_file, 'w') as f:
            json.dump(scene, f, indent=4)

        try:
            from renderformer_tpu_torch.scene.h5_tools import (
                save_dict_to_h5_renderformer_method)
            save_dict_to_h5_renderformer_method(scene, str(self.h5_path / f'{scene_name}.h5'))

            # the blenderproc GT runs per scene, tolerated where it is not
            # installed; the other GT modes render in one pass afterwards
            if self.gt_mode == 'blender':
                if shutil.which('blenderproc'):
                    script = Path(__file__).parent / 'scene' / self.config['SCRIPT_NAME']
                    cmd = (f'blenderproc run {script} -j {json_file} '
                           f'-o {self.gt_path} -i {scene_name}.png')
                    proc = await asyncio.create_subprocess_shell(
                        cmd, stdout=asyncio.subprocess.PIPE,
                        stderr=asyncio.subprocess.PIPE)
                    _, stderr = await proc.communicate()
                    if proc.returncode != 0:
                        print(f'Warning: GT render failed for {scene_name}: '
                              f'{stderr.decode()[:500]}')
                else:
                    print(f'Warning: blenderproc not available; no GT for '
                          f'{scene_name} (scene JSON/H5 still written; use '
                          f'--gt_mode pathtrace|model|raster for an in-framework GT)')
            print(f'Generated scene {scene_name}')
        except Exception as e:  # one scene's failure leaves the others, as the JAX script
            traceback.print_exc()
            print(f'Error converting {scene_name}: {e} (JSON kept at {json_file})')

    async def _generate_scene_task(self, scene_index: int):
        name, scene = self.next_scene(scene_index)
        await self.save_scene_async(scene, name)
        return scene_index

    async def generate_dataset(self):
        sem = asyncio.Semaphore(self.config['MAX_CONCURRENT_TASKS'])

        async def limited(i):
            async with sem:
                return await self._generate_scene_task(i)

        results = await asyncio.gather(
            *[limited(i) for i in range(self.config['NUM_RANDOM_SCENES'])],
            return_exceptions=True)
        ok = sum(1 for r in results if not isinstance(r, Exception))
        print(f'Dataset generation completed: {ok} successful, {len(results) - ok} failed')

    def generate_dataset_sync(self):
        asyncio.run(self.generate_dataset())
        self.render_gt_batch()

    # ------------------------------------------------------------------
    def render_gt_batch(self):
        """GT PNGs for every generated H5 file, by the configured
        in-framework source, in one pass after the scenes."""
        if self.gt_mode not in GT_RENDERERS:
            return
        from renderformer_tpu_torch.io.h5 import load_scene_h5
        h5_files = sorted(glob.glob(str(self.h5_path / '*.h5')))
        if not h5_files:
            return
        cfg = self.config
        render_gt({Path(f).stem: load_scene_h5(f) for f in h5_files}, self.gt_mode,
                  str(self.gt_path), resolution=int(cfg['GT_RESOLUTION']),
                  spp=int(cfg['GT_SPP']), seed=int(cfg['GT_SEED']), preset=cfg['GT_PRESET'],
                  checkpoint=cfg['GT_CHECKPOINT'], device=cfg['DEVICE'])


def build_config(args) -> dict:
    config = dict(CONFIG)
    if args.data_path:
        config['DATA_PATH'] = args.data_path
        config['JSON_PATH'] = os.path.join(args.data_path, 'json')
        config['H5_PATH'] = os.path.join(args.data_path, 'h5')
        config['GT_PATH'] = os.path.join(args.data_path, 'gt')
    if args.obj_path:
        config['OBJ_PATH'] = args.obj_path
    config.update(NUM_RANDOM_SCENES=args.num_scenes, GT_MODE=args.gt_mode,
                  GT_RESOLUTION=args.gt_resolution, GT_PRESET=args.gt_preset,
                  GT_CHECKPOINT=args.gt_checkpoint, GT_SPP=args.gt_spp,
                  GT_SEED=args.gt_seed, DEVICE='cpu' if args.cpu else None)
    if args.seed is not None:
        config['GT_SEED'] = args.seed
    return config


def build_parser():
    import argparse
    ap = argparse.ArgumentParser(
        description='Random Cornell-box scenes with ground truth (PyTorch/CUDA)')
    ap.add_argument('--data_path', default=None, help='dataset root (json/h5/gt subdirs)')
    ap.add_argument('--num_scenes', type=int, default=CONFIG['NUM_RANDOM_SCENES'])
    ap.add_argument('--obj_path', default=None)
    ap.add_argument('--gt_mode', default=CONFIG['GT_MODE'],
                    choices=['blender', 'model', 'raster', 'pathtrace', 'none', 'auto'])
    ap.add_argument('--gt_resolution', type=int, default=CONFIG['GT_RESOLUTION'])
    ap.add_argument('--gt_preset', default=CONFIG['GT_PRESET'],
                    help="'tiny' | 'v1-base' | 'v1.1-swin-large' (gt_mode=model)")
    ap.add_argument('--gt_checkpoint', default=None,
                    help='local checkpoint dir for gt_mode=model')
    ap.add_argument('--gt_spp', type=int, default=CONFIG['GT_SPP'],
                    help='samples per pixel (gt_mode=pathtrace)')
    ap.add_argument('--gt_seed', type=int, default=CONFIG['GT_SEED'],
                    help='weight-init seed for gt_mode=model / RNG seed for '
                         'gt_mode=pathtrace')
    ap.add_argument('--seed', type=int, default=None,
                    help='scene randomization seed (also the GT seed)')
    ap.add_argument('--cpu', action='store_true',
                    help='run the pathtrace and model GT on the CPU (default: the CUDA device)')
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = build_config(args)
    if args.seed is not None:
        random.seed(args.seed)
    gen = SceneGenerator(config)
    if not gen.available_objects:
        print(f'no .obj files under {config["OBJ_PATH"]}')
        return 1
    gen.generate_dataset_sync()
    return 0


if __name__ == '__main__':
    sys.exit(main())
