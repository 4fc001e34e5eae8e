"""A/B timing of the port's fused RMSNorm (K11) on one GPU.

    python3 tools/torch_norm_ab.py --parent OLD_DIR [--bwd] [--burst 20] [--iters 10]

``OLD_DIR`` holds a parent's ``fused_norm.cu`` with its ``common.cuh``, and
its ``ops/fused_norm.py`` and ``_build.py``: the sources are built into a
library of their own, and the parent's wrapper module is loaded from its
file and bound to that library, so that the parent's host path (its checks,
its cast of the scale, its stream lookup) is timed as well as its kernel.

At each K11 forward site of the v1-base nerf 512^2 render, of the nerf
256^2 train step and of the v1-base and v1.1-swin-large 512^2 renders'
ray tokens (x [R, D] in the dtype the path runs there, the scale in the
same dtype, as a stage's cast weights arrive), the parent's and the
working tree's wrappers are timed in turns (parent, change, change,
parent), each checked against the plain version, beside
``torch.nn.functional.rms_norm`` on the same inputs:

  * single: one call between two CUDA events, the median of ``--iters``;
    where the card waits for the host, this holds the host's work;
  * device: a CUDA graph of ``--burst`` calls replayed between two events,
    divided by the burst: the device time alone;
  * host_us: host microseconds a call, over 200 calls.

With ``--bwd``, the backward instead, at each K11 site of the nerf train
step (the scale in x's dtype, as a stage's cast weights arrive): each
version's ``_FusedRMSNorm.backward`` as autograd calls it (the parent's
wrapper and its ds cast, or the working tree's one launch), beside autograd
of ``F.rms_norm`` (its forward run once, its backward timed), with the same
three timings; its error is dx's and ds's (as fp32) against the plain
version.

Prints the card's nvidia-smi line, then one JSON line a site.  Both versions
run in one process on one card, so their times compare.
"""

import argparse
import ctypes
import glob
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NORM_D = 768
EPS_TINY = float(np.finfo(np.float32).eps)
SITES = [  # name, rows, dtype name, eps, width
    ('embed_2048', 2048, 'bfloat16', EPS_TINY, NORM_D),
    ('stage1_2064', 2064, 'bfloat16', 1e-6, NORM_D),
    ('rays_8x4096', 8 * 4096, 'bfloat16', 1e-6, NORM_D),
    ('tris_8x2064', 8 * 2064, 'bfloat16', 1e-6, NORM_D),
    ('train_rays_1024', 1024, 'float32', 1e-6, NORM_D),
    ('train_tris_2064', 2064, 'float32', 1e-6, NORM_D),
    ('swin_rays_8x4096', 8 * 4096, 'bfloat16', 1e-6, 1024),
    ('swin_stage1_4112', 4112, 'bfloat16', 1e-6, 1024),
]
BWD_SITES = [  # the nerf train step's backward sites
    ('train_embed_2048', 2048, 'bfloat16', EPS_TINY),
    ('train_stage1_2064', 2064, 'bfloat16', 1e-6),
    ('train_rays_1024', 1024, 'float32', 1e-6),
    ('train_tris_2064', 2064, 'float32', 1e-6),
]


def event_ms(fn, iters):
    """Median milliseconds of one fn() between two CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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


def graph_ms(fn, burst, iters, side=None):
    """Device milliseconds a call: a CUDA graph of ``burst`` calls replayed
    between two events, divided by the burst; fn is warmed up and captured
    on ``side`` (a new stream by default)."""
    import torch
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(burst):
            fn()
    return event_ms(graph.replay, iters) / burst


def host_us(fn, calls=200):
    """Host microseconds a call of fn()."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_module(src_dir, out_dir, module_file, names):
    """The parent's wrapper module ``module_file`` (in ``src_dir``), bound to
    its own kernels built from ``src_dir`` with its own _build.py's
    signatures of the C entry points ``names``."""
    from renderformer_tpu_torch import _build
    pbuild = load_module('parent_build', os.path.join(src_dir, '_build.py'))
    so = os.path.join(out_dir, 'libparent.so')
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-shared', '-I', src_dir,
                    *sorted(glob.glob(os.path.join(src_dir, '*.cu'))), '-o', so], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(so)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = pbuild.SIGNATURES[name]
        fn.restype = ctypes.c_int
    mod = load_module('parent_' + os.path.splitext(module_file)[0],
                      os.path.join(src_dir, module_file))
    fns = {}

    def function(name):  # as _build.function, on the parent's library
        if name not in fns:
            fns[name] = lib[name]
            fns[name].restype = ctypes.c_int
        return fns[name]

    mod._build = types.SimpleNamespace(library=lambda: lib, function=function,
                                       DTYPE_CODES=pbuild.DTYPE_CODES, check=_build.check)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help="directory holding the parent's fused_norm.cu, common.cuh, "
                         'fused_norm.py and _build.py')
    ap.add_argument('--bwd', action='store_true',
                    help='time the backward at the nerf train step\'s sites')
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--burst', type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops import fused_norm, reference_kernels

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        parent = parent_module(os.path.abspath(args.parent), tmp, 'fused_norm.py',
                               ('rf_rms_norm_fwd', 'rf_rms_norm_bwd'))
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    g = torch.Generator(device='cuda').manual_seed(0)
    if args.bwd:
        return bwd_sites(parent, fused_norm, g, args)
    for site, r, dtname, eps, d in SITES:
        dt = getattr(torch, dtname)
        x = torch.randn(r, d, generator=g, device='cuda').to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device='cuda')).to(dt)
        with torch.inference_mode():
            with reference_kernels():
                ref = fused_norm.rms_norm_fwd(x, w, eps)
            res = {}
            for name, mod in (('parent', parent), ('change', fused_norm),
                              ('change', fused_norm), ('parent', parent)):
                fn = lambda: mod.rms_norm_fwd(x, w, eps)  # noqa: E731
                err = float((fn().float() - ref.float()).abs().max())
                res.setdefault(name, []).append(dict(
                    single=round(event_ms(fn, args.iters), 4),
                    device=round(graph_ms(fn, args.burst, args.iters), 4),
                    host_us=round(host_us(fn), 2), err=err))
            lib = lambda: F.rms_norm(x, (d,), w, eps)  # noqa: E731
            res['rms_norm'] = dict(single=round(event_ms(lib, args.iters), 4),
                                   device=round(graph_ms(lib, args.burst, args.iters), 4),
                                   host_us=round(host_us(lib), 2))
        nbytes = 2 * r * d * x.element_size() + d * w.element_size()
        print(json.dumps({'site': site, 'dtype': dtname, 'rows': r, 'width': d, **res,
                          'bound_ms': round(nbytes / 3.35e12 * 1e3, 5)}), flush=True)


def bwd_sites(parent, fused_norm, gen, args):
    """The backward's A/B at BWD_SITES (see the module's note)."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    for site, r, dtname, eps in BWD_SITES:
        dt = getattr(torch, dtname)
        x = torch.randn(r, NORM_D, generator=gen, device='cuda').to(dt)
        gy = torch.randn(r, NORM_D, generator=gen, device='cuda').to(dt)
        w = (1 + 0.1 * torch.randn(NORM_D, generator=gen, device='cuda')).to(dt)
        ctx = types.SimpleNamespace(saved_tensors=(x, w), eps=eps)
        with torch.no_grad():
            with reference_kernels():
                ref = fused_norm.rms_norm_bwd(x, w.float(), gy, eps)  # ds in fp32
            res = {}
            for name, mod in (('parent', parent), ('change', fused_norm),
                              ('change', fused_norm), ('parent', parent)):
                fn = lambda: mod._FusedRMSNorm.backward(ctx, gy)[:2]  # noqa: E731
                err = [float((o.float() - f.float()).abs().max()) for o, f in zip(fn(), ref)]
                res.setdefault(name, []).append(dict(
                    single=round(event_ms(fn, args.iters), 4),
                    device=round(graph_ms(fn, args.burst, args.iters), 5),
                    host_us=round(host_us(fn), 2), err=err))
        # autograd of F.rms_norm: its forward once, on the stream that
        # captures its backward, where autograd launches it
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            yl = F.rms_norm(xl, (NORM_D,), wl, eps)
        torch.cuda.current_stream().wait_stream(side)
        lib = lambda: torch.autograd.grad(yl, (xl, wl), gy, retain_graph=True)  # noqa: E731
        res['rms_norm_autograd'] = dict(single=round(event_ms(lib, args.iters), 4),
                                        device=round(graph_ms(lib, args.burst, args.iters,
                                                              side), 5),
                                        host_us=round(host_us(lib), 2))
        nbytes = 3 * r * NORM_D * x.element_size() + 2 * NORM_D * w.element_size()
        print(json.dumps({'site': site, 'dtype': dtname, 'rows': r, 'pass': 'bwd', **res,
                          'bound_ms': round(nbytes / 3.35e12 * 1e3, 5)}), flush=True)


if __name__ == '__main__':
    main()
