"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``.  Each
source compiles in its own ``nvcc`` process, all started together, then
one link.  The library lands in ``build/<hash>/`` beside this file, where
the hash covers the sources and the flags, so an edited source rebuilds
and an unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_ROOT = os.path.join(_HERE, 'build')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = [*ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lib = None
_lock = threading.Lock()
_functions = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # q, k_rot, v, mask, cos, sin, out, lse, dtype, has_mask, B, reps, Sq, Sk,
    # H, D, qscale, stream
    'rf_flash_fwd_rope': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _F, _P],
    # q, k, v, mask, out, lse, dtype, has_mask, B, Sq, Sk, H, D, qscale, stream
    'rf_flash_fwd': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, B, Sq, H -> rows of q a block of the flash forward takes
    'rf_flash_fwd_rows': [_I, _I, _I, _I],
    # dtype, B, Sq, Sk, H -> blocks that split a q tile's keys (fp32 kernel)
    'rf_flash_fwd_splits': [_I, _I, _I, _I, _I],
    # q, k, v, dout, lse, delta, mask, dq_acc, dk, dv, dtype, has_mask, B,
    # reps, Sq, Sk, H, D, qscale, dqscale, dkscale, stream
    'rf_flash_bwd_kv': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _F, _F, _F, _P],
    # dtype, B, Sq, Sk, H -> blocks that split a key tile's q steps (dK/dV kernel)
    'rf_flash_bwd_splits': [_I, _I, _I, _I, _I],
    # dtype -> keys a block of the dK/dV kernel owns
    'rf_flash_bwd_keys': [_I],
    # q, k, v, dout, lse, delta, mask, dq, dtype, has_mask, B, reps, Sq, Sk,
    # H, D, qscale, dqscale, stream
    'rf_flash_bwd_dq': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _F, _P],
    # k, cos, sin, out, dtype, B, reps, Sk, H, D, stream
    'rf_rot_kv_broadcast': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, out, dtype, B, IH, IW, OH, OW, C, stream
    'rf_resize_bilinear': [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, out, span_h, w_h, taps_h, span_w, w_w, taps_w, dtype, B, IH, IW, OH,
    # OW, C, stream
    'rf_resize_bilinear_t': [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # x, out, dtype, B, IH, IW, OH, OW, C, stream
    'rf_resize_s2d': [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, table, out, B, nW, ws, row_bytes, stream
    'rf_shifted_regroup': [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, regions, out, dtype, has_mask, BW, nW, H, qscale, stream
    'rf_swin_window_attention': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, scale, y, dtype, scale dtype, R, D, eps, stream
    'rf_rms_norm_fwd': [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, scale, g, dx, ds, ds_part, ticket slot, dtype, scale dtype, R, D,
    # blocks, rows_per_block, eps, stream
    'rf_rms_norm_bwd': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, D -> blocks of the backward the card holds at once
    'rf_rms_norm_bwd_capacity': [_I, _I],
}
DTYPE_CODES = {'bfloat16': 0, 'float32': 1}


def nvcc_path() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the kernels build only where the '
                           'CUDA toolkit is installed')
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, '*.cu')))


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, '*'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the library if the sources changed; return its path."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    lib_path = os.path.join(out_dir, 'librf_kernels.so')
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    nvcc = nvcc_path()
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix='tmp-')
    try:
        procs = []
        objs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-I', CSRC, '-c', src, '-o', obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if verbose or p.returncode:
                print(f'--- nvcc {os.path.basename(src)} (rc {p.returncode})\n{log}')
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}')
        tmp_lib = os.path.join(tmp, 'librf_kernels.so')
        subprocess.run([nvcc, *ARCH, '-shared', *objs, '-o', tmp_lib], check=True)
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def function(name: str):
    """The C entry point ``name`` of the library, looked up once, as a
    function object of its own without argtypes: a ctypes call converts the
    ints and the ``ctypes.c_void_p`` pointers (and ``c_float`` floats) it is
    given at half the cost of one that checks each against declared
    argtypes."""
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = library()[name]
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc}')
