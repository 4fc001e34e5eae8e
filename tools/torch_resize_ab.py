"""A/B timing of the port's bilinear resize (K4, K5) on one GPU: host and device.

    python3 tools/torch_resize_ab.py --parent OLD_DIR [--burst 20] [--iters 10]

``OLD_DIR`` holds a parent's ``resize.cu`` with its ``common.cuh``, and its
``ops/fused_resize.py`` and ``_build.py``: the sources are built into a
library of their own, and the parent's wrapper module is loaded from its
file and bound to that library, so that the parent's host path (its checks,
its dtype code, its stream lookup) is timed as well as its kernel.

At each K4 site of the v1-base 256^2 train step (x [1, n, n, 128] fp32, n
16, 32, 64, upsampled 2x) and of the 512^2 renders (x [8, n, n, 128] bf16,
n 32, 64, 128), the parent's and the working tree's wrappers are timed in
turns (parent, change, change, parent), each checked against the plain
version, beside ``torch.nn.functional.interpolate`` (bilinear,
align_corners=True) on the same values in NCHW view:

  * single: one call between two CUDA events, the median of ``--iters``;
    where the card waits for the host, this holds the host's work;
  * device: a CUDA graph of ``--burst`` calls replayed between two events,
    divided by the burst: the device time alone;
  * host_us: host microseconds a call, over 200 calls.

Then the same for K5 (the resize into space-to-depth layout) at its two
sites, the renders' x [8, 256, 256, 128] bf16 to 512^2 and the train step's
x [1, 128, 128, 128] fp32 to 256^2, beside F.interpolate followed by
space_to_depth; its error must be 0 (bit for bit with the plain version).

Prints the card's nvidia-smi line, then one JSON line a site.  Both versions
run in one process on one card, so their times compare.  Last, one JSON
line splits the working tree's host path at the first train site into its
parts (host µs a call of each), beside ``F.interpolate``'s.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))

from torch_norm_ab import event_ms, graph_ms, host_us, parent_module  # noqa: E402

SITES = [  # name, batch, n in, dtype name
    ('train_16to32', 1, 16, 'float32'),
    ('train_32to64', 1, 32, 'float32'),
    ('train_64to128', 1, 64, 'float32'),
    ('render_32to64', 8, 32, 'bfloat16'),
    ('render_64to128', 8, 64, 'bfloat16'),
    ('render_128to256', 8, 128, 'bfloat16'),
]
S2D_SITES = [  # K5: name, batch, n in, dtype name
    ('train_128to256_s2d', 1, 128, 'float32'),
    ('render_256to512_s2d', 8, 256, 'bfloat16'),
]
C = 128  # dpt_features of both models


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help="directory holding the parent's resize.cu, common.cuh, "
                         'fused_resize.py and _build.py')
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--burst', type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops import fused_resize, reference_kernels
    from renderformer_tpu_torch.ops.s2d_conv import space_to_depth

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        parent = parent_module(os.path.abspath(args.parent), tmp, 'fused_resize.py',
                               ('rf_resize_bilinear', 'rf_resize_s2d', 'rf_resize_bilinear_t'))
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    g = torch.Generator(device='cuda').manual_seed(0)
    for site, b, n, dtname in SITES + S2D_SITES:
        s2d = (site, b, n, dtname) in S2D_SITES
        fname = 'resize_s2d' if s2d else 'resize_bilinear'
        dt = getattr(torch, dtname)
        x = torch.randn(b, n, n, C, generator=g, device='cuda').to(dt)
        hw = (2 * n, 2 * n)
        xc = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            with reference_kernels():
                ref = getattr(fused_resize, fname)(x, hw)
            res = {}
            for name, mod in (('parent', parent), ('change', fused_resize),
                              ('change', fused_resize), ('parent', parent)):
                fn = lambda: getattr(mod, fname)(x, hw)  # noqa: E731
                err = float((fn().float() - ref.float()).abs().max())
                res.setdefault(name, []).append(dict(
                    single=round(event_ms(fn, args.iters), 4),
                    device=round(graph_ms(fn, args.burst, args.iters), 5),
                    host_us=round(host_us(fn), 2), err=err))
            lib = lambda: F.interpolate(xc, size=hw, mode='bilinear',  # noqa: E731
                                        align_corners=True)
            if s2d:
                lib = lambda: space_to_depth(F.interpolate(  # noqa: E731
                    xc, size=hw, mode='bilinear', align_corners=True).permute(0, 2, 3, 1))
            res['interpolate'] = dict(single=round(event_ms(lib, args.iters), 4),
                                      device=round(graph_ms(lib, args.burst, args.iters), 5),
                                      host_us=round(host_us(lib), 2))
        nbytes = b * (n * n + 4 * n * n) * C * x.element_size()
        print(json.dumps({'site': site, 'dtype': dtname, **res,
                          'bound_ms': round(nbytes / 3.35e12 * 1e3, 5)}), flush=True)
        del x, xc, ref
        torch.cuda.empty_cache()

    host_parts(fused_resize, F)


def host_parts(fr, F):
    """Host µs a call of each part of the working tree's K4 wrapper at the
    first train site: the shape check, the kernel checks and stream, the
    output's allocation, the C call alone, the whole call; and
    F.interpolate."""
    import torch
    x = torch.randn(1, 16, 16, C, device='cuda')
    xc = x.permute(0, 3, 1, 2)
    out = x.new_empty((1, 32, 32, C))
    xp, code, stream = fr._kernel_args('x', x, C)
    fn = fr._build.function('rf_resize_bilinear')
    op = fr._ptr(out.data_ptr())
    with torch.inference_mode():
        parts = {
            'check_input': lambda: fr._check_input(x, (32, 32)),
            'kernel_args': lambda: fr._kernel_args('x', x, C),
            'new_empty': lambda: x.new_empty((1, 32, 32, C)),
            'c_call': lambda: fn(xp, op, code, 1, 16, 16, 32, 32, C, stream),
            'whole': lambda: fr.resize_bilinear(x, (32, 32)),
            'interpolate': lambda: F.interpolate(xc, size=(32, 32), mode='bilinear',
                                                 align_corners=True),
        }
        print(json.dumps({'host_parts_us': {k: round(host_us(f, 2000), 2)
                                            for k, f in parts.items()}}), flush=True)


if __name__ == '__main__':
    main()
