"""Alternative GT renderer: raw Blender (Cycles) via a generated bpy
script and a ``blender --background`` subprocess (the JAX package's
``scene/blender_render.py``).

Follows the reference implementation's ``scene_processor/blender_render.py``:
configurable Cycles settings (samples, GPU, denoising, caustics, light
bounces, exposure, transparency), EXR + PNG outputs.  Requires a Blender
binary on PATH — construction raises a clear error otherwise, as the
reference does.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Optional


@dataclass
class BlenderRenderConfig:
    resolution: int = 512
    samples: int = 128
    use_gpu: bool = True
    use_denoising: bool = True
    denoiser_type: str = 'OPENIMAGEDENOISE'
    transparent: bool = True
    light_bounces: int = 8
    caustics: bool = True
    exposure: float = 1.0
    film_transparent: bool = True
    color_mode: str = 'RGBA'
    color_depth: str = '32'
    exr_codec: str = 'DWAA'


_BPY_TEMPLATE = r'''
import bpy
import json
import math

with open({scene_json!r}) as f:
    scene = json.load(f)
cfg = json.loads({cfg_json!r})

# reset scene
bpy.ops.wm.read_factory_settings(use_empty=True)
sc = bpy.context.scene
sc.render.engine = 'CYCLES'
sc.cycles.samples = cfg['samples']
sc.cycles.use_denoising = cfg['use_denoising']
sc.cycles.caustics_reflective = cfg['caustics']
sc.cycles.caustics_refractive = cfg['caustics']
sc.cycles.max_bounces = cfg['light_bounces']
sc.view_settings.exposure = cfg['exposure']
sc.render.film_transparent = cfg['film_transparent']
sc.render.resolution_x = cfg['resolution']
sc.render.resolution_y = cfg['resolution']
if cfg['use_gpu']:
    try:
        sc.cycles.device = 'GPU'
    except Exception:
        pass

def make_material(name, m):
    mat = bpy.data.materials.new(name)
    mat.use_nodes = True
    bsdf = mat.node_tree.nodes['Principled BSDF']
    bsdf.inputs['Base Color'].default_value = list(m['diffuse']) + [1.0]
    bsdf.inputs['Roughness'].default_value = m['roughness']
    try:
        bsdf.inputs['Specular IOR Level'].default_value = sum(m['specular']) / 3.0
    except KeyError:
        bsdf.inputs['Specular'].default_value = sum(m['specular']) / 3.0
    if any(e > 0 for e in m['emissive']):
        bsdf.inputs['Emission Strength'].default_value = sum(m['emissive']) / 3.0
        try:
            bsdf.inputs['Emission Color'].default_value = [1, 1, 1, 1]
        except KeyError:
            pass
    return mat

for key, obj_data in scene['objects'].items():
    bpy.ops.wm.obj_import(filepath=obj_data['mesh_path'])
    obj = bpy.context.selected_objects[0]
    t = obj_data['transform']
    obj.rotation_euler = [math.radians(a) for a in t['rotation']]
    obj.scale = t['scale']
    obj.location = t['translation']
    mat = make_material(key, obj_data['material'])
    if obj.data.materials:
        obj.data.materials[0] = mat
    else:
        obj.data.materials.append(mat)

# camera: first scene camera, look-at orientation
cam_cfg = scene['cameras'][0]
cam_data = bpy.data.cameras.new('cam')
cam_data.angle = math.radians(cam_cfg['fov'])
cam = bpy.data.objects.new('cam', cam_data)
sc.collection.objects.link(cam)
cam.location = cam_cfg['position']
direction = [l - p for l, p in zip(cam_cfg['look_at'], cam_cfg['position'])]
import mathutils
cam.rotation_euler = mathutils.Vector(direction).to_track_quat('-Z', 'Y').to_euler()
sc.camera = cam

# PNG output
sc.render.image_settings.file_format = 'PNG'
sc.render.filepath = {png_path!r}
bpy.ops.render.render(write_still=True)

# EXR output
sc.render.image_settings.file_format = 'OPEN_EXR'
sc.render.image_settings.color_mode = cfg['color_mode']
sc.render.image_settings.color_depth = cfg['color_depth']
sc.render.image_settings.exr_codec = cfg['exr_codec']
sc.render.filepath = {exr_path!r}
bpy.ops.render.render(write_still=True)
'''


class BlenderRenderer:
    def __init__(self, config: Optional[BlenderRenderConfig] = None):
        self.config = config or BlenderRenderConfig()
        self._check_blender_installation()

    def _check_blender_installation(self):
        try:
            result = subprocess.run(['blender', '--version'],
                                    capture_output=True, text=True, check=True)
            print(f'Found Blender: {result.stdout.splitlines()[0]}')
        except (subprocess.CalledProcessError, FileNotFoundError):
            raise RuntimeError(
                'Blender is not installed. Install with: '
                'sudo apt install blender')

    def render_scene(self, scene_json_path: str, output_dir: str,
                     image_name: str) -> str:
        """Render scene JSON -> PNG + EXR; returns the PNG path."""
        os.makedirs(output_dir, exist_ok=True)
        base = os.path.splitext(image_name)[0]
        png_path = os.path.join(os.path.abspath(output_dir), f'{base}.png')
        exr_path = os.path.join(os.path.abspath(output_dir), f'{base}.exr')

        cfg = self.config
        script = _BPY_TEMPLATE.format(
            scene_json=os.path.abspath(scene_json_path),
            cfg_json=json.dumps(cfg.__dict__),
            png_path=png_path,
            exr_path=exr_path,
        )
        with tempfile.NamedTemporaryFile(
                'w', suffix='.py', delete=False) as f:
            f.write(script)
            script_path = f.name
        try:
            result = subprocess.run(
                ['blender', '--background', '--python', script_path],
                capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError(
                    f'blender render failed:\n{result.stderr[-2000:]}')
        finally:
            os.unlink(script_path)
        return png_path
