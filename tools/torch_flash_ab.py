"""A/B timing of the port's flash-attention kernel (K1/K2) on one GPU.

    python3 tools/torch_flash_ab.py --parent OLD/flash_attention.cu

Builds ``OLD/flash_attention.cu`` (with the ``common.cuh`` beside it) into
a library of its own, then times the parent and the working tree's kernel
in turns (parent, change, change, parent) at the three attention sites of
the v1-base 512^2 render, in bf16 and fp32, and checks each against the
plain version.  Prints the card's nvidia-smi line, then one JSON line per
site and dtype with [median ms, max error] per turn.  Both versions run in
one process on one card, so their times compare.  A parent from before
``rf_flash_fwd_rope`` took its ``lse`` pointer is called without it.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SITES = [  # name, B, Bkv, Sq, Sk, masked
    ('stage1_self', 1, 1, 2064, 2064, True),
    ('cross', 8, 1, 4096, 2064, True),
    ('ray_self', 8, 8, 4096, 4096, False),
]


def time_ms(fn, iters):
    """Median milliseconds of fn() by CUDA events, after two warm-up calls."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class NoLseAbi:
    """A parent library whose ``rf_flash_fwd_rope`` has no ``lse`` pointer
    (the 8th argument of today's): calls drop it."""

    def __init__(self, lib, signature):
        sig = list(signature)
        del sig[7]
        self._fn = lib.rf_flash_fwd_rope
        self._fn.argtypes = sig
        self._fn.restype = ctypes.c_int

    def rf_flash_fwd_rope(self, *args):
        if args[7] is not None:
            raise ValueError('the parent library writes no logsumexp')
        return self._fn(*args[:7], *args[8:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help='flash_attention.cu of the parent version')
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args()

    import torch
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_fwd_rope, launch_flash_fwd_rope)

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    src = os.path.abspath(args.parent)
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        so = os.path.join(tmp, 'libparent.so')
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-shared', '-I',
                        os.path.dirname(src), src, '-o', so], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        parent = ctypes.CDLL(so)
    with open(src) as f:
        takes_lse = 'void* lse' in f.read()
    signature = _build.SIGNATURES['rf_flash_fwd_rope']
    if takes_lse:
        parent.rf_flash_fwd_rope.argtypes = signature
        parent.rf_flash_fwd_rope.restype = ctypes.c_int
    else:
        parent = NoLseAbi(parent, signature)
    change = _build.library()
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    dev = 'cuda'
    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for site, b, bkv, sq, sk, masked in SITES:
            q = torch.randn(b, sq, 6, 128, generator=g, device=dev).to(dt)
            k = torch.randn(b, sk, 6, 128, generator=g, device=dev).to(dt)
            v = torch.randn(bkv, sk, 6, 128, generator=g, device=dev).to(dt)
            pos = torch.randn(b, sq, 9, generator=g, device=dev) * 0.3
            c, s = make_cos_sin(pos, 12, 128)
            c, s = c[:, :, 0].contiguous(), s[:, :, 0].contiguous()
            mask = None
            if masked:
                mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
                mask[:, 1552:] = False

            res = {}
            with torch.inference_mode():
                with reference_kernels():
                    ref = flash_fwd_rope(q, k, v, mask, c, s)
                for name, lib in (('parent', parent), ('change', change),
                                  ('change', change), ('parent', parent)):
                    def fn(lib=lib):
                        return launch_flash_fwd_rope(lib, q, k, v, mask, c, s)
                    err = float((fn().float() - ref.float()).abs().max())
                    res.setdefault(name, []).append(
                        (round(time_ms(fn, args.iters), 4), err))
            print(json.dumps({'site': site, 'dtype': str(dt).split('.')[-1], **res}),
                  flush=True)


if __name__ == '__main__':
    main()
