"""A/B timing of the port's bilinear resize (K4, K5) and its adjoint (K4^T) on one GPU.

    python3 tools/torch_resize_ab.py --parent OLD_DIR [--burst 20] [--iters 10]
                                     [--sites train_16to32,...]

``OLD_DIR`` holds a parent's ``resize.cu`` with its ``common.cuh``, and its
``ops/fused_resize.py`` and ``_build.py``: the sources are built into a
library of their own, and the parent's wrapper module is loaded from its
file and bound to that library, so that the parent's host path (its checks,
its dtype code, its stream lookup) is timed as well as its kernel.  A copy of
the working tree's files with one kernel edited times that variant the same
way.

At each K4 site of the v1-base 256^2 train step (x [1, n, n, 128] fp32, n
16, 32, 64, upsampled 2x) and of the 512^2 renders (x [8, n, n, 128] bf16,
n 32, 64, 128), the parent's and the working tree's wrappers are timed in
turns (parent, change, change, parent), each checked against the plain
version (err) and against the parent's output (vs_parent, which must be 0:
bit for bit), beside ``torch.nn.functional.interpolate`` (bilinear,
align_corners=True) on the same values in NCHW view, and at the K4 sites
the device time of the call followed by the add that reads its output next
(``next_device``: what cached stores save the next kernel):

  * single: one call between two CUDA events, the median of ``--iters``;
    where the card waits for the host, this holds the host's work;
  * device: a CUDA graph of ``--burst`` calls replayed between two events,
    divided by the burst: the device time alone, where an input that fits
    in L2 (50 MB) stays there from call to call;
  * cold: the same for a graph of calls each after a sum over a 128 MB
    buffer, less the sums alone: the device time of a call whose inputs come
    from device memory, as in a step or a render;
  * host_us: host microseconds a call, over 200 calls.

Then the same for K5 (the resize into space-to-depth layout) at its two
sites, the renders' x [8, 256, 256, 128] bf16 to 512^2 and the train step's
x [1, 128, 128, 128] fp32 to 256^2, beside F.interpolate followed by
space_to_depth; its error must be 0 (bit for bit with the plain version).

Then K4^T at the train step's four sites, g [1, 2n, 2n, 128] fp32 to n 16,
32, 64 and 128 (NHWC g), and at K5's VJP, g [1, 128, 128, 512] in
space-to-depth layout to n 128: the parent there runs its backward route,
depth_to_space(g).contiguous() then its K4^T, the change K4^T on g in place.
Beside them autograd of F.interpolate (then space_to_depth) for the same
cotangent, its forward run on the capturing stream.

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
T_SITES = [  # K4^T: name, batch, n in (the adjoint's output), dtype name, g in s2d layout
    ('train_32to16_t', 1, 16, 'float32', False),
    ('train_64to32_t', 1, 32, 'float32', False),
    ('train_128to64_t', 1, 64, 'float32', False),
    ('train_256to128_t', 1, 128, 'float32', False),
    ('train_256to128_t_s2d', 1, 128, 'float32', True),
]
C = 128  # dpt_features of both models


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help="directory holding the parent's resize.cu, common.cuh, "
                         'fused_resize.py and _build.py')
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--burst', type=int, default=20)
    ap.add_argument('--sites', default='',
                    help='comma-separated site names to time (default: all)')
    args = ap.parse_args()
    keep = set(filter(None, args.sites.split(',')))

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
        if keep and site not in keep:
            continue
        s2d = (site, b, n, dtname) in S2D_SITES
        fname = 'resize_s2d' if s2d else 'resize_bilinear'
        dt = getattr(torch, dtname)
        x = torch.randn(b, n, n, C, generator=g, device='cuda').to(dt)
        hw = (2 * n, 2 * n)
        xc = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            with reference_kernels():
                ref = getattr(fused_resize, fname)(x, hw)
            base = getattr(parent, fname)(x, hw)
            # K4 then the add that reads its output next in a refinenet
            r = None if s2d else torch.randn(base.shape, generator=g, device='cuda').to(dt)
            res = {}
            for name, mod in (('parent', parent), ('change', fused_resize),
                              ('change', fused_resize), ('parent', parent)):
                fn = lambda: getattr(mod, fname)(x, hw)  # noqa: E731
                res.setdefault(name, []).append(turn(fn, ref, base, args, r))
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
        del x, xc, ref, base, r
        torch.cuda.empty_cache()

    for site, b, n, dtname, s2d in T_SITES:
        if keep and site not in keep:
            continue
        transposed_site(parent, fused_resize, site, b, n, getattr(torch, dtname), s2d, g, args)

    host_parts(fused_resize, F)


def cold_ms(fn, args):
    """Device milliseconds a call of fn() finds its inputs out of L2: a
    graph of (a sum over a 128 MB buffer, which fills L2 with clean lines,
    then the call) less a graph of the sums alone."""
    import torch
    buf = torch.ones(32 << 20, device='cuda')

    def flush():
        return buf.sum()

    both = graph_ms(lambda: (flush(), fn()), args.burst, args.iters)
    return both - graph_ms(flush, args.burst, args.iters)


def turn(fn, ref, base, args, nxt=None):
    """One turn of a version at a site: its times, its error against the
    plain version and its difference from the parent's output; with ``nxt``
    also the device time of the call followed by an add of nxt to its
    output (``next_device``), which reads the output from L2 where the
    kernel's stores left it there."""
    import torch
    out = fn().float()
    res = dict(single=round(event_ms(fn, args.iters), 4),
               device=round(graph_ms(fn, args.burst, args.iters), 5),
               cold=round(cold_ms(fn, args), 5), host_us=round(host_us(fn), 2),
               err=float((out - ref.float()).abs().max()),
               vs_parent=float((out - base.float()).abs().max()))
    if nxt is not None:
        res['next_device'] = round(graph_ms(lambda: torch.add(fn(), nxt), args.burst,
                                            args.iters), 5)
    return res


def transposed_site(parent, fr, site, b, n, dt, s2d, gen, args):
    """K4^T's turns at one site (see the module's docstring)."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.s2d_conv import depth_to_space, space_to_depth
    hw = (n, n)
    g = torch.randn(b, 2 * n, 2 * n, C, generator=gen, device='cuda').to(dt)
    gl = g.permute(0, 3, 1, 2)
    if s2d:
        g = space_to_depth(g).contiguous()
        versions = {'parent': lambda: parent.resize_bilinear_t(depth_to_space(g).contiguous(), hw),
                    'change': lambda: fr.resize_s2d_t(g, hw)}
    else:
        versions = {'parent': lambda: parent.resize_bilinear_t(g, hw),
                    'change': lambda: fr.resize_bilinear_t(g, hw)}
    with torch.inference_mode():
        with reference_kernels():
            ref = versions['change']()
        base = versions['parent']()
        res = {}
        for name in ('parent', 'change', 'change', 'parent'):
            res.setdefault(name, []).append(turn(versions[name], ref, base, args))
    # autograd of F.interpolate (then space_to_depth), its forward on the
    # stream that captures its backward
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xl = torch.zeros(b, C, n, n, dtype=dt, device='cuda', requires_grad=True)
        yl = F.interpolate(xl, size=(2 * n, 2 * n), mode='bilinear', align_corners=True)
        if s2d:
            yl = space_to_depth(yl.permute(0, 2, 3, 1))
    gy = g if s2d else gl

    def lib():
        return torch.autograd.grad(yl, xl, gy, retain_graph=True)

    with torch.cuda.stream(side):
        single, hus = event_ms(lib, args.iters), host_us(lib)
    res['interpolate'] = dict(single=round(single, 4),
                              device=round(graph_ms(lib, args.burst, args.iters, side), 5),
                              host_us=round(hus, 2))
    nbytes = b * (n * n + 4 * n * n) * C * g.element_size()
    print(json.dumps({'site': site, 'dtype': str(dt).split('.')[-1], **res,
                      'bound_ms': round(nbytes / 3.35e12 * 1e3, 5)}), flush=True)


def host_parts(fr, F):
    """Host µs a call of each part of the working tree's K4 wrapper at the
    first train site: the shape check, the kernel checks and stream, the
    output's allocation, the (cached) plan, the C call alone, the whole
    call; and F.interpolate."""
    import torch
    x = torch.randn(1, 16, 16, C, device='cuda')
    xc = x.permute(0, 3, 1, 2)
    out = x.new_empty((1, 32, 32, C))
    xp, code, stream = fr._kernel_args('x', x, C)
    fn = fr._build.function('rf_resize_bilinear')
    op = fr._ptr(out.data_ptr())
    _, ppb = fr.row_plan(32, 32, C // 4, 16)
    with torch.inference_mode():
        parts = {
            'check_input': lambda: fr._check_input(x, (32, 32)),
            'kernel_args': lambda: fr._kernel_args('x', x, C),
            'new_empty': lambda: x.new_empty((1, 32, 32, C)),
            'row_plan': lambda: fr.row_plan(32, 32, C // 4, 16),
            'c_call': lambda: fn(xp, op, code, 1, 16, 16, 32, 32, C, ppb, stream),
            'whole': lambda: fr.resize_bilinear(x, (32, 32)),
            'interpolate': lambda: F.interpolate(xc, size=(32, 32), mode='bilinear',
                                                 align_corners=True),
        }
        print(json.dumps({'host_parts_us': {k: round(host_us(f, 2000), 2)
                                            for k, f in parts.items()}}), flush=True)


if __name__ == '__main__':
    main()
