"""Look-at camera matrix (numpy; the JAX package's ``utils/look_at.py``).

Follows the reference implementation's ``scene_processor/to_h5.py``.
"""

from __future__ import annotations

import numpy as np


def look_at_to_c2w(camera_position, target_position=(0.0, 0.0, 0.0),
                   up_dir=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world matrix for a camera at ``camera_position`` looking at
    ``target_position`` with the given up direction."""
    cam_pos = np.asarray(camera_position, dtype=np.float64)
    target = np.asarray(target_position, dtype=np.float64)
    up = np.asarray(up_dir, dtype=np.float64)

    forward = cam_pos - target
    forward = forward / np.linalg.norm(forward)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(forward, right)
    cam_up = cam_up / np.linalg.norm(cam_up)

    # world->camera = rotation @ translation; invert to get c2w
    rot = np.zeros((4, 4))
    rot[0, :3] = right
    rot[1, :3] = cam_up
    rot[2, :3] = forward
    rot[3, 3] = 1.0
    trans = np.eye(4)
    trans[:3, 3] = -cam_pos
    w2c = rot @ trans
    return np.linalg.inv(w2c)
