"""A/B timing of the port's flash-attention forward (K1/K2 and K10) or backward (K8, K9) on one GPU.

    python3 tools/torch_flash_ab.py --parent OLD_DIR [--burst 20] [--fp32] [--sites a,b]
    python3 tools/torch_flash_ab.py --parent OLD_DIR --bwd [--burst 20] [--sites a,b]
    python3 tools/torch_flash_ab.py --parent OLD_DIR --rot [--burst 20] [--sites a,b]

Builds every ``*.cu`` in ``OLD_DIR`` (a parent's ``flash_attention.cu``,
with its ``common.cuh``, ``flash_fwd_sm90.cu`` and any other source it
includes, beside it) into a library of its own, then times the parent and
the working tree's kernels in turns (parent, change, change, parent) at the
attention sites of the v1-base, v1.1-swin-large and v1-base nerf 512^2
renders and of the v1-base and nerf 256^2 train steps (with the
logsumexp, as the step runs them), in bf16 (and fp32 with ``--fp32``),
each checked against the plain version.  A turn is the median over
``--iters`` timings of ``--burst`` launches between two CUDA events,
divided by the burst, so that the kernel's time is read without the host's
enqueue.  SDPA on the same inputs, the bound (bf16 tensor cores; for fp32
split TF32 on the tensor cores, and scalar fp32 FMAs beside it) and the
fp32 kernel's key split are printed beside each site.  With ``--fp32`` a
profiler run of SDPA in fp32 at each train site names the kernels behind
it.  Then the host's cost of one wrapper call (checks, tensor maps,
launch) is timed in turns at a tiny shape, where the card waits for the
host.  Prints the card's nvidia-smi line, then one JSON line a site and
dtype.  Both versions run in one process on one card, so their times
compare.

With ``--bwd`` (``OLD_DIR`` holding a parent's ``flash_bwd.cu`` and
``common.cuh``, and where it has them its ``flash_bwd_sm90.cu``/``.cuh``,
``flash_bwd_dq_sm90.cu``/``.cuh``, ``flash_fwd_sm90.cu``/``.cuh`` and
``sm90.cuh``) the backward is timed instead, at the v1-base and nerf
256^2 train step's sites in the dtype the step runs there (the bf16
stage-1 self-attention, the fp32 cross- and ray self-attention; the nerf
step's sites have the same shapes): K8 (``'fused'``), K9's dK/dV kernel
(``'dkv'``, the same template without dQ) and K9's dQ kernel (``'dq'``),
each turn checked against the plain backward and timed three ways: the
median of bursts of launches, the device time of a call by a CUDA graph of
``--burst`` calls, and one call between two CUDA events.  Beside them:
autograd of SDPA on the same inputs (all three gradients, dk/dv alone, dq
alone; dq alone also by CUDA graphs) and each kernel's bound (10, 8 and 6
Sq*Sk*D flops a head for K8, dK/dV and dQ: bf16 tensor cores; for fp32
split TF32, and scalar fp32 FMAs beside it).  Each site prints the plans
(the bf16 dK/dV kernel's keys a block; the dQ kernel's q rows a block and
key split; blocks on the card's SMs).

With ``--rot`` (``OLD_DIR`` holding a parent's ``rot_kv.cu`` and
``common.cuh``) the K broadcast-rotate (K3) is timed instead, at every
RoPE attention site of the v1-base and v1.1-swin-large 512^2 renders and of
the v1-base 256^2 train step, in the dtype each runs it: each turn the
device time of a call, a CUDA graph of ``--burst`` calls replayed between
two CUDA events (the median of ``--iters``) divided by the burst, checked
against the plain version, beside the bytes bound (K read once for all the
views of a scene, the fp32 tables, the output written once).
"""

import argparse
import ctypes
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PEAK_BF16_TENSOR = 989e12  # H100 SXM dense bf16 tensor-core flop/s
PEAK_FP32 = 67e12          # H100 SXM fp32 flop/s outside the tensor cores
PEAK_TF32 = 494.7e12       # H100 SXM dense TF32 tensor-core flop/s

SITES = [  # name, kernel, B, Bkv, Sq, Sk, H, masked, with the logsumexp
    ('stage1_self', 'rope', 1, 1, 2064, 2064, 6, True, False),
    ('cross', 'rope', 8, 1, 4096, 2064, 6, True, False),
    ('ray_self', 'rope', 8, 8, 4096, 4096, 6, False, False),
    ('stage1_self_h8', 'rope', 1, 1, 2064, 2064, 8, True, False),
    ('cross_h8', 'rope', 8, 1, 4096, 2064, 8, True, False),
    ('nerf_stage1_self', 'k10', 1, 1, 2064, 2064, 6, True, False),
    ('nerf_cross', 'k10', 8, 8, 4096, 2064, 6, True, False),
    ('nerf_ray_self', 'k10', 8, 8, 4096, 4096, 6, False, False),
    ('train_cross', 'rope', 1, 1, 1024, 2064, 6, True, True),
    ('train_ray_self', 'rope', 1, 1, 1024, 1024, 6, False, True),
    ('train_nerf_cross', 'k10', 1, 1, 1024, 2064, 6, True, True),
    ('train_nerf_ray_self', 'k10', 1, 1, 1024, 1024, 6, False, True),
]


def time_ms(fn, iters, burst):
    """Median milliseconds a call of fn() by CUDA events around bursts of
    ``burst`` calls, after a warm-up burst."""
    import torch
    for _ in range(burst):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def host_us(fn, calls=200):
    """Host microseconds a call of fn(), the card never the bottleneck."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def print_sdpa_kernels(site, fn):
    """The CUDA kernels one call of fn() runs, by the profiler: which
    kernel computes SDPA in fp32 here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    print(json.dumps({'sdpa_fp32_kernels': site, 'names': names}), flush=True)


def build_parent(src_dir, out_dir):
    from renderformer_tpu_torch import _build
    so = os.path.join(out_dir, 'libparent.so')
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-shared', '-I', src_dir,
                    *sorted(glob.glob(os.path.join(src_dir, '*.cu'))), '-o', so], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(so)
    for name in ('rf_flash_fwd_rope', 'rf_flash_fwd', 'rf_flash_bwd_kv', 'rf_flash_bwd_dq',
                 'rf_flash_bwd_dq_splits', 'rf_rot_kv_broadcast'):
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


BWD_SITES = [  # name, dtype name, Sq, Sk, masked: the train step's sites, H 6
    ('train_stage1_self', 'bfloat16', 2064, 2064, True),
    ('train_cross', 'float32', 1024, 2064, True),
    ('train_ray_self', 'float32', 1024, 1024, False),
]


# Sq*Sk*D flops a head of each backward kernel: K8's five products, the
# dK/dV kernel's four (S^T, dP^T, dV, dK), the dQ kernel's three (S, dP, dQ)
BWD_FLOPS = {'fused': 10, 'dkv': 8, 'dq': 6}


def bwd_main(args):
    """The backward's A/B (``--bwd``)."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_dq_rows, flash_bwd_dq_splits, flash_bwd_keys, flash_bwd_splits,
        flash_fwd, launch_flash_bwd)
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from torch_norm_ab import event_ms, graph_ms

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    change = _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        parent = build_parent(os.path.abspath(args.parent), tmp)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device='cuda').manual_seed(0)
    h = 6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for site, dtname, sq, sk, masked in BWD_SITES:
        if args.sites and site not in args.sites.split(','):
            continue
        dt = getattr(torch, dtname)
        q, do = (torch.randn(1, sq, h, 128, generator=g, device='cuda').to(dt) for _ in range(2))
        k, v = (torch.randn(1, sk, h, 128, generator=g, device='cuda').to(dt) for _ in range(2))
        mask = None
        if masked:
            mask = torch.ones(1, sk, dtype=torch.bool, device='cuda')
            mask[:, 1552:] = False  # a padded tail of triangles
        with torch.no_grad():
            with reference_kernels():
                out, lse = flash_fwd(q, k, v, mask, with_lse=True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            io = (q, k, v, mask, lse, delta, do)
            with reference_kernels():
                ref = flash_bwd(*io)
            # chip_smoke.py's bar: 2 * attention_tol per output
            tols = [float(r.float().abs().max()) * (8 * 2.0 ** -8 if dt == torch.bfloat16
                                                    else 2.0 ** -15) for r in ref]
            res = {}
            for kernels in ('fused', 'dkv', 'dq'):
                for name, lib in (('parent', parent), ('change', change),
                                  ('change', change), ('parent', parent)):
                    got = launch_flash_bwd(lib, kernels, *io)
                    worst = max(float((x.float() - r.float()).abs().max()) / t
                                for x, r, t in zip(got, ref, tols) if x is not None)

                    def call():
                        return launch_flash_bwd(lib, kernels, *io)

                    res.setdefault(f'{kernels}_{name}', []).append(dict(
                        burst=round(time_ms(call, args.iters, args.burst), 4),
                        graph=round(graph_ms(call, args.burst, args.iters), 4),
                        single=round(event_ms(call, args.iters), 4),
                        err_bar=round(worst, 4)))
        qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        am = mask[:, None, None, :] if masked else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # autograd's backward launches on the capturing stream
            y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
        torch.cuda.current_stream().wait_stream(side)
        gy = do.transpose(1, 2).contiguous()

        def sdpa_grad(*wrt):
            return lambda: torch.autograd.grad(y, wrt, gy, retain_graph=True)

        sdpa = {'all': time_ms(sdpa_grad(qs, ks, vs), args.iters, args.burst),
                'kv': time_ms(sdpa_grad(ks, vs), args.iters, args.burst),
                'q': time_ms(sdpa_grad(qs), args.iters, args.burst),
                'q_graph': graph_ms(sdpa_grad(qs), args.burst, args.iters, side),
                'q_single': event_ms(sdpa_grad(qs), args.iters)}
        bound = {}
        for kernels, units in BWD_FLOPS.items():
            flops = units * h * sq * sk * 128
            bound[f'{kernels}_bound_ms'] = round(
                flops / (PEAK_BF16_TENSOR if dt == torch.bfloat16 else PEAK_TF32 / 3) * 1e3, 4)
            if dt == torch.float32:
                bound[f'{kernels}_bound_simt_ms'] = round(flops / PEAK_FP32 * 1e3, 4)
        rows = flash_bwd_dq_rows(dt, 1, sq, h)
        dq_splits = flash_bwd_dq_splits(dt, 1, sq, sk, h)
        plan = {'dq_rows_a_block': rows, 'dq_splits': dq_splits,
                'dq_parent_splits': (parent.rf_flash_bwd_dq_splits(_build.DTYPE_CODES[dtname], 1,
                                                                   sq, sk, h)
                                     if hasattr(parent, 'rf_flash_bwd_dq_splits') else None),
                'dq_blocks': -(-sq // rows) * h * dq_splits, 'sms': sms}
        if dt == torch.bfloat16:
            keys = flash_bwd_keys(dt)
            plan.update(keys_a_block=keys, q_step=64, blocks=-(-sk // keys) * h)
        print(json.dumps({'site': site, 'dtype': dtname,
                          'splits': flash_bwd_splits(dt, 1, sq, sk, h), **plan,
                          'turns (ms, err/bar)': res,
                          'sdpa_bwd_ms': round(sdpa['all'], 4),
                          'sdpa_bwd_kv_ms': round(sdpa['kv'], 4),
                          'sdpa_bwd_q_ms': round(sdpa['q'], 4),
                          'sdpa_bwd_q_graph_ms': round(sdpa['q_graph'], 4),
                          'sdpa_bwd_q_single_ms': round(sdpa['q_single'], 4),
                          **bound}), flush=True)
        del q, do, k, v, out, lse, delta, io, ref, qs, ks, vs, y, gy
        torch.cuda.empty_cache()


ROT_SITES = [  # name, dtype name, B, Bkv, Sk, H: every K3 site of the renders and the step
    ('stage1_self', 'bfloat16', 1, 1, 2064, 6),
    ('cross', 'bfloat16', 8, 1, 2064, 6),
    ('ray_self', 'bfloat16', 8, 8, 4096, 6),
    ('stage1_self_h8', 'bfloat16', 1, 1, 2064, 8),
    ('cross_h8', 'bfloat16', 8, 1, 2064, 8),
    ('train_stage1_self', 'bfloat16', 1, 1, 2064, 6),
    ('train_cross', 'float32', 1, 1, 2064, 6),
    ('train_ray_self', 'float32', 1, 1, 1024, 6),
]


def rot_main(args):
    """K3's A/B (``--rot``)."""
    import torch
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops.flash_attention import rot_kv_broadcast_plain
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from torch_norm_ab import graph_ms

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    change = _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        parent = build_parent(os.path.abspath(args.parent), tmp)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device='cuda').manual_seed(0)
    d = 128
    for site, dtname, b, bkv, sk, h in ROT_SITES:
        if args.sites and site not in args.sites.split(','):
            continue
        dt = getattr(torch, dtname)
        k = torch.randn(bkv, sk, h, d, generator=g, device='cuda').to(dt)
        c, s = make_cos_sin(torch.randn(b, sk, 9, generator=g, device='cuda') * 0.3, 12, d)
        c, s = c[:, :, 0].contiguous(), s[:, :, 0].contiguous()
        out = torch.empty(b, sk, h, d, dtype=dt, device='cuda')
        it = k.element_size()
        nbytes = bkv * sk * h * d * it + 2 * b * sk * d * 4 + b * sk * h * d * it
        bound = nbytes / 3.35e12 * 1e3
        with torch.inference_mode():
            ref = rot_kv_broadcast_plain(k, c, s)
            # k3_tol of chip_smoke.py: one ulp of the largest output
            tol = float(ref.float().abs().max()) * (2.0 ** -7 if dt == torch.bfloat16
                                                    else 2.0 ** -22)

            def call(lib):
                return lambda: _build.check(lib.rf_rot_kv_broadcast(
                    k.data_ptr(), c.data_ptr(), s.data_ptr(), out.data_ptr(),
                    _build.DTYPE_CODES[dtname], b, b // bkv, sk, h, d,
                    torch.cuda.current_stream().cuda_stream), 'rf_rot_kv_broadcast')

            res = {}
            for name, lib in (('parent', parent), ('change', change),
                              ('change', change), ('parent', parent)):
                out.zero_()
                call(lib)()
                err = float((out.float() - ref.float()).abs().max())
                ms = graph_ms(call(lib), args.burst, args.iters)
                res.setdefault(name, []).append(
                    {'ms': round(ms, 5), 'bound_share': round(bound / ms, 3),
                     'err/tol': round(err / tol, 3)})
        print(json.dumps({'site': site, 'dtype': dtname, 'B': b, 'Bkv': bkv, 'Sk': sk, 'H': h,
                          'bytes': nbytes, 'bound_ms': round(bound, 5), **res}), flush=True)
        del k, c, s, out, ref
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help="directory holding the parent's flash_attention.cu, common.cuh and "
                         'flash_fwd_sm90.cu/.cuh')
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--burst', type=int, default=20)
    ap.add_argument('--fp32', action='store_true', help='also time the fp32 kernel')
    ap.add_argument('--bwd', action='store_true',
                    help="time the backward (K8, K9's dK/dV and dQ) instead of the forward")
    ap.add_argument('--rot', action='store_true',
                    help='time the K broadcast-rotate (K3) instead of the forward')
    ap.add_argument('--sites', help='comma-separated site names (default: all)')
    args = ap.parse_args()
    if args.bwd:
        return bwd_main(args)
    if args.rot:
        return rot_main(args)
    sites = [x for x in SITES if not args.sites or x[0] in args.sites.split(',')]

    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.encodings.rope import apply_rope, make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        fan_out, flash_fwd, flash_fwd_rope, flash_fwd_rows, flash_fwd_splits, launch_flash_fwd,
        launch_flash_fwd_rope)

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    change = _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        parent = build_parent(os.path.abspath(args.parent), tmp)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    dev = 'cuda'
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def tables(b, s):
        c, sn = make_cos_sin(torch.randn(b, s, 9, generator=g, device=dev) * 0.3, 12, 128)
        return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()

    def site_fns(kind, q, k, v, mask, c, s, lse=None):
        """(launch on a library, plain version) of one site, writing the
        logsumexp into ``lse`` where given."""
        if kind == 'rope':
            return (lambda lib: launch_flash_fwd_rope(lib, q, k, v, mask, c, s, lse),
                    lambda: flash_fwd_rope(q, k, v, mask, c, s))
        return (lambda lib: launch_flash_fwd(lib, q, k, v, mask, lse),
                lambda: flash_fwd(q, k, v, mask))

    dtypes = (torch.bfloat16, torch.float32) if args.fp32 else (torch.bfloat16,)
    for dt in dtypes:
        for site, kind, b, bkv, sq, sk, h, masked, with_lse in sites:
            q = randn(b, sq, h, 128, dtype=dt)
            k = randn(b, sk, h, 128, dtype=dt)
            v = randn(bkv, sk, h, 128, dtype=dt)
            c, s = tables(b, sq)
            mask = None
            if masked:
                mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
                mask[:, 1552:] = False  # a padded tail of triangles
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if with_lse else None
            launch, plain = site_fns(kind, q, k, v, mask, c, s, lse)
            res = {}
            with torch.inference_mode():
                with reference_kernels():
                    ref = plain()
                for name, lib in (('parent', parent), ('change', change),
                                  ('change', change), ('parent', parent)):
                    err = float((launch(lib).float() - ref.float()).abs().max())
                    res.setdefault(name, []).append(
                        (round(time_ms(lambda: launch(lib), args.iters, args.burst), 4), err))
                # the library yardstick: SDPA on q as the kernel reads it (rotated
                # for K1/K2), with its own 1/sqrt(D)
                qr = q if kind == 'k10' else apply_rope(q, c[:, :, None, :], s[:, :, None, :])
                qs = qr.transpose(1, 2).contiguous()
                ks = k.transpose(1, 2).contiguous()
                vs = fan_out(v, b).transpose(1, 2).contiguous()
                am = mask[:, None, None, :] if masked else None
                sdpa = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                               args.iters, args.burst)
                if dt == torch.float32 and with_lse:
                    print_sdpa_kernels(site, lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=am))
            flops = 4 * b * h * sq * sk * 128
            bound = {'bound_ms': round(flops / PEAK_BF16_TENSOR * 1e3, 4)}
            if dt == torch.float32:
                bound = {'bound_ms': round(3 * flops / PEAK_TF32 * 1e3, 4),
                         'bound_simt_ms': round(flops / PEAK_FP32 * 1e3, 4)}
            print(json.dumps({'site': site, 'kernel': kind, 'dtype': str(dt).split('.')[-1],
                              'lse': with_lse, 'rows': flash_fwd_rows(dt, b, sq, h),
                              'splits': flash_fwd_splits(dt, b, sq, sk, h), **res,
                              'sdpa_ms': round(sdpa, 4), **bound}), flush=True)
            del q, k, v, qr, qs, ks, vs, ref, lse
            torch.cuda.empty_cache()

    # the wrapper's host cost at a tiny shape: checks, tensor maps, launch
    q, k, v = (randn(1, 64, 1, 128, dtype=torch.bfloat16) for _ in range(3))
    c, s = tables(1, 64)
    with torch.inference_mode():
        for kind in ('rope', 'k10'):
            launch, _ = site_fns(kind, q, k, v, None, c, s)
            res = {}
            for name, lib in (('parent', parent), ('change', change),
                              ('change', change), ('parent', parent)):
                res.setdefault(name, []).append(round(host_us(lambda: launch(lib)), 2))
            print(json.dumps({'host_us_a_call': kind, **res}), flush=True)


if __name__ == '__main__':
    main()
