"""Ground-truth rendering via BlenderProc (runs under ``blenderproc run``;
the JAX package's ``scene/render_scene.py``).

Follows the reference implementation's ``scene_processor/render_scene.py``:
loads the scene JSON into BlenderProc, principled-BSDF materials (base
color / roughness / specular IOR level / emission strength), camera poses
from look-at, renders PNG ground truth.

This module only works inside a ``blenderproc run`` environment (Blender
is not a dependency of this package); ``generate_dataset`` gates on the
``blenderproc`` binary being present before invoking it.
"""

import argparse
import json
import os

import numpy as np


def render_scene_from_json(json_path: str, save_dir: str, image_name: str):
    import blenderproc as bproc  # only importable under `blenderproc run`
    from PIL import Image

    with open(json_path) as f:
        scene_config = json.load(f)

    bproc.init()
    bproc.clean_up()

    for obj_name, obj_data in scene_config['objects'].items():
        obj = bproc.loader.load_obj(obj_data['mesh_path'])[0]

        transform = obj_data['transform']
        obj.set_location(transform['translation'])
        obj.set_rotation_euler(
            [np.radians(a) for a in transform['rotation']])
        obj.set_scale(transform['scale'])

        material = obj_data['material']
        mats = obj.get_materials()
        mat = mats[0] if mats else bproc.material.create('Material')

        mat.set_principled_shader_value(
            'Base Color', material['diffuse'] + [1.0])
        mat.set_principled_shader_value('Metallic', 0.0)
        mat.set_principled_shader_value('Roughness', material['roughness'])
        mat.set_principled_shader_value(
            'Specular IOR Level', sum(material['specular']) / 3.0)
        if any(e > 0 for e in material['emissive']):
            mat.set_principled_shader_value(
                'Emission Strength', sum(material['emissive']) / 3.0)
        if not mats:
            obj.add_material(mat)

    for camera_config in scene_config['cameras']:
        position = camera_config['position']
        direction = (np.array(camera_config['look_at'])
                     - np.array(position))
        rotation = bproc.camera.rotation_from_forward_vec(direction)
        cam_pose = bproc.math.build_transformation_mat(position, rotation)
        bproc.camera.add_camera_pose(cam_pose)
        bproc.camera.set_intrinsics_from_blender_params(
            lens=np.radians(camera_config['fov']), lens_unit='FOV')

    data = bproc.renderer.render()
    os.makedirs(save_dir, exist_ok=True)
    image_path = os.path.join(save_dir, image_name)
    Image.fromarray(
        (data['colors'][0] * 255).astype(np.uint8)).save(image_path)
    print(f'saved GT render to {image_path}')


def main():
    parser = argparse.ArgumentParser(
        description='Render a scene from JSON using BlenderProc')
    parser.add_argument('--json_path', '-j', required=True)
    parser.add_argument('--output_path', '-o', required=True)
    parser.add_argument('--image_name', '-i', required=True)
    args = parser.parse_args()
    render_scene_from_json(args.json_path, args.output_path, args.image_name)


if __name__ == '__main__':
    main()
