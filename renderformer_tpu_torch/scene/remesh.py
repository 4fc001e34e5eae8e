"""Remeshing: isotropic remesh and quadric decimation to a target face count
(the JAX package's ``scene/remesh.py``).

The reference implementation uses pymeshlab (its
``scene_processor/remesh.py``).  This repository ships its own C++
implementation, ``native/meshops.cpp``, which the port compiles with ``g++``
(the flags of ``native/Makefile``) at first use into ``build/<hash>/`` beside
this package, the hash covering the source and the flags, and loads through
``ctypes``.  Nothing is written into ``native/``.  This is host code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), 'native', 'meshops.cpp')
BUILD_ROOT = os.path.join(_PKG, 'build')
CXX_FLAGS = ['-O2', '-std=c++17', '-fPIC', '-Wall', '-shared']

_lib = None
_lock = threading.Lock()

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_int64)
_IP = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int


def build() -> str:
    """Compile ``native/meshops.cpp`` if it or the flags changed; return the
    library's path.  Raises if the source is missing or ``g++`` fails."""
    if not os.path.exists(SOURCE):
        raise RuntimeError(f'{SOURCE} not found: remeshing needs the repository checkout')
    with open(SOURCE, 'rb') as f:
        src = f.read()
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f'meshops-{digest}')
    lib_path = os.path.join(out_dir, 'libmeshops.so')
    if os.path.exists(lib_path):
        return lib_path
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('g++ not found: remeshing builds native/meshops.cpp with it')
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix='.so')
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, SOURCE],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise RuntimeError(f'g++ failed on {SOURCE} (rc {res.returncode}):\n'
                               f'{res.stdout}{res.stderr}')
        os.replace(tmp, lib_path)  # atomic: processes building at once agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.meshops_decimate.restype = ctypes.c_int
            lib.meshops_decimate.argtypes = [
                _D, _I,          # verts, nv
                _L, _I,          # faces, nf
                _I,              # target faces
                _D, _L,          # out verts, out faces
                _IP, _IP,        # out nv, out nf
            ]
            lib.meshops_isotropic_remesh.restype = ctypes.c_int
            lib.meshops_isotropic_remesh.argtypes = [
                _D, _I, _L, _I,
                ctypes.c_double, _I,       # edge len, iterations
                _D, _L, _IP, _IP,
                _I, _I,                    # capacities
            ]
            _lib = lib
        return _lib


def decimate(vertices: np.ndarray, faces: np.ndarray,
             target_faces: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric-error-metric edge-collapse decimation (QSlim-style, the
    algorithm behind pymeshlab's simplification filter)."""
    lib = _load_lib()
    v = np.ascontiguousarray(vertices, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv_out = ctypes.c_int(0)
    nf_out = ctypes.c_int(0)
    rc = lib.meshops_decimate(
        v.ctypes.data_as(_D), len(v), f.ctypes.data_as(_L), len(f), int(target_faces),
        out_v.ctypes.data_as(_D), out_f.ctypes.data_as(_L),
        ctypes.byref(nv_out), ctypes.byref(nf_out))
    if rc != 0:
        raise RuntimeError(f'meshops_decimate failed: {rc}')
    return out_v[:nv_out.value].copy(), out_f[:nf_out.value].copy()


def isotropic_remesh(vertices: np.ndarray, faces: np.ndarray,
                     target_edge_len: float,
                     iterations: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Isotropic explicit remeshing: split long edges / collapse short
    edges / flip for valence / tangential relax (pymeshlab
    meshing_isotropic_explicit_remeshing equivalent)."""
    lib = _load_lib()
    v = np.ascontiguousarray(vertices, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    # splits can grow the mesh: generous output capacity
    cap_v = max(len(v) * 16, 65536)
    cap_f = max(len(f) * 16, 131072)
    out_v = np.empty((cap_v, 3), np.float64)
    out_f = np.empty((cap_f, 3), np.int64)
    nv_out = ctypes.c_int(0)
    nf_out = ctypes.c_int(0)
    rc = lib.meshops_isotropic_remesh(
        v.ctypes.data_as(_D), len(v), f.ctypes.data_as(_L), len(f),
        float(target_edge_len), int(iterations),
        out_v.ctypes.data_as(_D), out_f.ctypes.data_as(_L),
        ctypes.byref(nv_out), ctypes.byref(nf_out), cap_v, cap_f)
    if rc != 0:
        raise RuntimeError(f'meshops_isotropic_remesh failed: {rc}')
    return out_v[:nv_out.value].copy(), out_f[:nf_out.value].copy()


def remesh(input_v: np.ndarray, input_f: np.ndarray,
           expected_face_num: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's entry (its ``scene_processor/remesh.py``): isotropic
    remesh toward a uniform edge length, then decimate to the exact target
    face count."""
    v = np.asarray(input_v, np.float64)
    f = np.asarray(input_f, np.int64)
    # pick a target edge length from total area ~= n_faces * (sqrt(3)/4) l^2
    tri = v[f]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1).sum()
    edge_len = float(np.sqrt(area / max(expected_face_num, 1)
                             / (np.sqrt(3) / 4.0)))
    # each pass splits at most the longest edge of every face (face count
    # can at best double per pass) — very coarse inputs (a 12-face box vs
    # a 2048-face target) need ~log2(ratio) extra passes
    grow = max(expected_face_num / max(len(f), 1), 1.0)
    iters = 5 + int(np.ceil(np.log2(grow)))
    v2, f2 = isotropic_remesh(v, f, edge_len, iterations=iters)
    if len(f2) > expected_face_num:
        v2, f2 = decimate(v2, f2, expected_face_num)
    return v2, f2
