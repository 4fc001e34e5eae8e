#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (renderformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card: the nvidia-smi name and power limit, and torch's device name;
  2. build: compiles the kernels from renderformer_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     every shape the v1-base and v1.1-swin-large 512^2 renders give it, in
     bf16 and fp32, with kernel, plain, library and bound times (CUDA
     events, median);
  4. render, for each of v1-base and v1.1-swin-large at full width and full
     depth from a seeded init, with the default composed DPT tail: 1 scene x
     8 views x 2048 triangles at 512^2 in bf16 (the bench.py workload), with
     exact launch counts of every kernel (counts set to 0 just before the
     render, read just after), finite output, and HDR PSNR against the same
     render through the plain versions (>= 40 dB; an fp32 render at 128^2
     must reach >= 55 dB);
  5. speed, for each model: rays/s of the bf16 render on inputs already on
     the card, median of timed renders, and a profiler breakdown of one
     render (device time by kernel, and the device's idle share of the
     median unprofiled render).
Then one JSON line with every kernel's numbers per render of each model,
the nvidia-smi line, and the result line.  Any failed check exits non-zero
before the result line.  Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_TENSOR = 989e12   # H100 SXM dense bf16 tensor-core flop/s
PEAK_FP32 = 67e12           # H100 SXM fp32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s

# the renders at 512^2, 8 views, 2048 triangles
V, RES, NTRI = 8, 512, 2048
SK = 2048 + 16          # triangles + register tokens
ST = (RES // 8) ** 2    # ray tokens
D = 128                 # head dim of both models
DPT_C = 128             # dpt_features of both models
SWIN_C, SWIN_H = 1024, 8
GRID = RES // 8         # the 64 x 64 patch grid
NW = (GRID // 8) ** 2   # 8 x 8 windows a view
BASE, SWIN = 'v1-base', 'v1.1-swin-large'
PATHS = (BASE, SWIN)

KERNELS = {
    'flash_fwd_rope_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_attention.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:876'),
    'flash_fwd_rope_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_attention.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:888'),
    'rot_kv_broadcast': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/rot_kv.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:819'),
    'resize_bilinear': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:100'),
    'resize_s2d': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:229'),
    'swin_window_attention': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/swin_attention.cu',
        replaces='renderformer_tpu/ops/swin_attention.py:72'),
    'shifted_regroup': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/shifted_regroup.cu',
        replaces='renderformer_tpu/ops/shifted_regroup.py:68'),
}
# launches in one bf16 512^2 render with the composed DPT tail:
# v1-base: 12 encoder + 6 decoder masked attentions (K1), 6 ray
#   self-attentions (K2), a K rotation before each (K3), refinenet4/3/2
#   upsamples (K4), refinenet1's upsample into s2d layout (K5);
# swin-large: 12 encoder + 12 decoder masked attentions (K1, K3), window
#   attention in every decoder layer (K6), the regroup before and after it in
#   the 6 shifted layers (K7), and the same DPT head.
EXPECTED_LAUNCHES = {
    BASE: {'flash_fwd_rope_mask': 18, 'flash_fwd_rope_nomask': 6,
           'rot_kv_broadcast': 24, 'resize_bilinear': 3, 'resize_s2d': 1,
           'swin_window_attention': 0, 'shifted_regroup': 0},
    SWIN: {'flash_fwd_rope_mask': 24, 'flash_fwd_rope_nomask': 0,
           'rot_kv_broadcast': 24, 'resize_bilinear': 3, 'resize_s2d': 1,
           'swin_window_attention': 12, 'shifted_regroup': 12},
}


def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if res.returncode:
        fail(f'nvidia-smi: {res.stderr.strip()}')
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() by CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
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


def bound_ms(nbytes, flops, flop_rate):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / flop_rate * 1e3
    return max(tb, tf), ('bytes' if tb >= tf else 'operations')


def psnr(ref, x):
    mse = float(((ref - x) ** 2).mean())
    peak = float(ref.max() - ref.min())
    return 10 * np.log10(peak ** 2 / max(mse, 1e-30))


def attention_tol(ref, dtype, what):
    """Output-scaled tolerance of the attention kernels (K1, K2, K6)."""
    import torch
    amax = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return amax * 4 * 2.0 ** -8, (
            f'q and P round to bf16 in both, {what}, and out rounds once to '
            'bf16: 4 ulps of max|ref|')
    return amax * 2.0 ** -16, 'fp32 sums in another order: 2^-16 of max|ref|'


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks():
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_fwd_rope, rot_kv_broadcast, rot_kv_broadcast_plain)
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear, resize_s2d
    from renderformer_tpu_torch.ops.s2d_conv import space_to_depth
    from renderformer_tpu_torch.ops.shifted_regroup import regroup_index, shifted_regroup
    from renderformer_tpu_torch.ops.swin_attention import (
        region_table, swin_window_attention)
    from renderformer_tpu_torch.nn.swin import swin_attn_mask

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def tables(b, s):
        pos = randn(b, s, 9) * 0.3
        c, sn = make_cos_sin(pos, rope_dim=12, head_dim=D)
        return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()

    def record(kernel, site, dtype, per_render, out, ref, tol, why, fn, lib_fn,
               nbytes, flops, flop_rate):
        """Check one (kernel, site, dtype) and time fn as the kernel and, inside
        reference_kernels(), as the plain version.  per_render: launches at
        this shape in one render of each model."""
        err = float((out.float() - ref.float()).abs().max())
        ms = time_ms(fn)
        with reference_kernels():
            plain_ms = time_ms(fn, iters=3, warmup=1)
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        bms, by = bound_ms(nbytes, flops, flop_rate)
        row = dict(kernel=kernel, site=site, dtype=str(dtype).split('.')[-1],
                   per_render=per_render, max_abs_err=err, tol=tol, tol_reason=why,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                   bound_by=by)
        print('kernel ' + json.dumps(row), flush=True)
        if not np.isfinite(err) or err > tol:
            fail(f'{kernel} {site} {row["dtype"]}: max err {err} > {tol}')
        rows.append(row)

    flash_sites = [  # name, B, Bkv, Sq, Sk, H, masked, launches per render
        ('stage1_self', 1, 1, SK, SK, 6, True, {BASE: 12}),
        ('cross', V, 1, ST, SK, 6, True, {BASE: 6}),
        ('ray_self', V, V, ST, ST, 6, False, {BASE: 6}),
        ('stage1_self_h8', 1, 1, SK, SK, 8, True, {SWIN: 12}),
        ('cross_h8', V, 1, ST, SK, 8, True, {SWIN: 12}),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        it = 2 if dtype == torch.bfloat16 else 4
        flop_rate = PEAK_BF16_TENSOR if dtype == torch.bfloat16 else PEAK_FP32
        for site, b, bkv, sq, sk, H, masked, n in flash_sites:
            q = randn(b, sq, H, D, dtype=dtype)
            k = randn(bkv, sk, H, D, dtype=dtype)
            v = randn(bkv, sk, H, D, dtype=dtype)
            cq, sq_t = tables(b, sq)
            ck, sk_t = (cq, sq_t) if sq == sk and b == bkv else tables(b, sk)
            mask = None
            if masked:
                mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
                mask[:, 16 + NTRI * 3 // 4:] = False  # a padded tail of triangles
            with torch.inference_mode():
                # K3 at this site
                out = rot_kv_broadcast(k, ck, sk_t)
                ref = rot_kv_broadcast_plain(k, ck, sk_t)
                tol = float(ref.float().abs().max()) * (2.0 ** -7 if dtype == torch.bfloat16
                                                       else 2.0 ** -22)
                record('rot_kv_broadcast', site, dtype, n, out, ref, tol,
                       'same fp32 arithmetic as the plain version; one ulp of the '
                       'largest output for a differently rounded product',
                       lambda: rot_kv_broadcast(k, ck, sk_t), None,
                       bkv * sk * H * D * it + 2 * b * sk * D * 4 + b * sk * H * D * it,
                       3 * b * sk * H * D, PEAK_FP32)
                k_rot = out
                # K1 / K2 at this site
                kname = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
                out = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t)
                with reference_kernels():
                    ref = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t)
                tol, why = attention_tol(
                    ref, dtype, 'P at the running max (online softmax) vs the row max')
                # library yardstick: SDPA on the rotated q, [B, H, S, D] layout
                qr = rot_kv_broadcast_plain(q, cq, sq_t)
                qs = qr.transpose(1, 2).contiguous()
                ks = k_rot.transpose(1, 2).contiguous()
                vs = v.repeat_interleave(b // bkv, dim=0).transpose(1, 2).contiguous()
                am = mask[:, None, None, :] if mask is not None else None
                record(kname, site, dtype, n, out, ref, tol, why,
                       lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t),
                       lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                       (b * sq * H * D * 2 + b * sk * H * D + bkv * sk * H * D) * it
                       + (b * sk if masked else 0) + 2 * b * sq * D * 4,
                       4 * b * H * sq * sk * D, flop_rate)
            del q, k, v, k_rot, out, ref, qr, qs, ks, vs
            torch.cuda.empty_cache()

        # K4: refinenet4/3/2 upsamples of both DPT heads
        for n_in in (32, 64, 128):
            x = randn(V, n_in, n_in, DPT_C, dtype=dtype)
            hw = (2 * n_in, 2 * n_in)
            with torch.inference_mode():
                out = resize_bilinear(x, hw)
                with reference_kernels():
                    ref = resize_bilinear(x, hw)
                amax = float(x.float().abs().max())
                if dtype == torch.bfloat16:
                    tol, why = amax * 2.0 ** -5, ('the plain version rounds frac, '
                                                  '1-frac and each lerp to bf16; the '
                                                  'kernel rounds once: 4 ulps of max|x|')
                else:
                    tol, why = amax * 2.0 ** -22, 'same fp32 ops in the same order'
                xc = x.permute(0, 3, 1, 2)
                record('resize_bilinear', f'{n_in}to{2 * n_in}', dtype,
                       {BASE: 1, SWIN: 1}, out, ref, tol, why,
                       lambda: resize_bilinear(x, hw),
                       lambda: F.interpolate(xc, size=hw, mode='bilinear',
                                             align_corners=True),
                       V * n_in * n_in * DPT_C * it + V * 4 * n_in * n_in * DPT_C * it,
                       8 * V * 4 * n_in * n_in * DPT_C, PEAK_FP32)
            del x, out, ref
            torch.cuda.empty_cache()

        # K5: refinenet1's upsample into s2d layout, the composed tail's input
        n_in = RES // 2
        x = randn(V, n_in, n_in, DPT_C, dtype=dtype)
        hw = (RES, RES)
        with torch.inference_mode():
            out = resize_s2d(x, hw)
            with reference_kernels():
                ref = resize_s2d(x, hw)
            xc = x.permute(0, 3, 1, 2)
            record('resize_s2d', f'{n_in}to{RES}_s2d', dtype, {BASE: 1, SWIN: 1},
                   out, ref, 0.0, 'the plain resize in fp32 rounded once, then '
                   'space_to_depth: the same ops in the same order, bit for bit',
                   lambda: resize_s2d(x, hw),
                   lambda: space_to_depth(F.interpolate(
                       xc, size=hw, mode='bilinear', align_corners=True
                   ).permute(0, 2, 3, 1)),
                   V * n_in * n_in * DPT_C * it + V * RES * RES * DPT_C * it,
                   8 * V * RES * RES * DPT_C, PEAK_FP32)
        del x, out, ref
        torch.cuda.empty_cache()

        # K7 and K6 at the swin-large shapes: [8, 4096, 1024] window-ordered
        # stream, [512, 64, 1024] window batches of 8 heads of 128
        x = randn(V, ST, SWIN_C, dtype=dtype)
        with torch.inference_mode():
            for inverse in (False, True):
                out = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
                with reference_kernels():
                    ref = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
                # library yardstick: the same permutation as one gather
                idx = torch.from_numpy(regroup_index(GRID, GRID, 8, inverse)).to(dev)
                if not torch.equal(x.index_select(1, idx), ref):
                    fail(f'regroup_index inverse={inverse} is not the regroup')
                record('shifted_regroup', 'inverse' if inverse else 'forward', dtype,
                       {SWIN: 6}, out, ref, 0.0, 'a permutation: exact',
                       lambda: shifted_regroup(x, (GRID, GRID), 8, inverse=inverse),
                       lambda: x.index_select(1, idx),
                       2 * V * ST * SWIN_C * it, 0, PEAK_FP32)
        del x, out, ref
        bw = V * NW
        q, k, v = (randn(bw, 64, SWIN_C, dtype=dtype) for _ in range(3))
        qh, kh, vh = (t.reshape(bw, 64, SWIN_H, D).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        for shift in (0, 4):
            regions = region_table(GRID, GRID, 8, shift, dev) if shift else None
            am = None
            if shift:
                am = torch.from_numpy(swin_attn_mask(GRID, GRID, 8, shift)).to(dev)
                am = am.repeat(V, 1, 1)[:, None]
            with torch.inference_mode():
                out = swin_window_attention(q, k, v, num_heads=SWIN_H, regions=regions)
                with reference_kernels():
                    ref = swin_window_attention(q, k, v, num_heads=SWIN_H,
                                                regions=regions)
                tol, why = attention_tol(ref, dtype, 'sums of e and P.V in another order')
                record('swin_window_attention', 'shifted' if shift else 'unshifted',
                       dtype, {SWIN: 6}, out, ref, tol, why,
                       lambda: swin_window_attention(q, k, v, num_heads=SWIN_H,
                                                     regions=regions),
                       lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am),
                       4 * bw * 64 * SWIN_C * it + (NW * 64 if shift else 0),
                       4 * bw * SWIN_H * 64 * 64 * D, flop_rate)
            del out, ref
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the render
# ---------------------------------------------------------------------------

def bench_inputs(n_tris=NTRI, n_views=V):
    """bench.py's workload, made from numpy seed 0."""
    rng = np.random.default_rng(0)
    return (
        rng.normal(size=(1, n_tris, 3, 3)).astype(np.float32) * 0.3,
        rng.uniform(0, 1, (1, n_tris, 13, 32, 32)).astype(np.float32),
        np.ones((1, n_tris), bool),
        rng.normal(size=(1, n_tris, 3, 3)).astype(np.float32),
        np.tile(np.eye(4, dtype=np.float32), (1, n_views, 1, 1)),
        np.full((1, n_views, 1), 40.0, np.float32),
    )


def render_checks(card, preset):
    """Phases 4 and 5 for one model; returns its launch counts and the
    median render time."""
    import torch
    from renderformer_tpu_torch import RenderingPipeline
    from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels, reset_launch_counts

    t0 = time.time()
    pipe = RenderingPipeline.from_pretrained(preset, seed=0)
    n_params = sum(p.numel() for p in pipe.model.state_dict().values())
    print(f'render: {preset} seeded init, {n_params} parameters, '
          f'{time.time() - t0:.1f} s', flush=True)
    args = bench_inputs()

    reset_launch_counts()
    img = pipe.render(*args, resolution=RES, precision='bf16')
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'render: {preset} launches ' + json.dumps(launches), flush=True)
    if launches != EXPECTED_LAUNCHES[preset]:
        fail(f'{preset} launch counts {launches} != {EXPECTED_LAUNCHES[preset]}')
    if tuple(img.shape) != (1, V, RES, RES, 3):
        fail(f'{preset} render shape {tuple(img.shape)}')
    if not bool(torch.isfinite(img).all()):
        fail(f'{preset} render has non-finite values')
    with reference_kernels():
        ref = pipe.render(*args, resolution=RES, precision='bf16')
    p_bf16 = psnr(ref.float().cpu().numpy(), img.float().cpu().numpy())
    print(f'render: {preset} bf16 512^2 kernels vs plain HDR PSNR {p_bf16:.2f} dB '
          f'(need >= 40); mean {float(img.mean()):.6f} std {float(img.std()):.6f}',
          flush=True)
    if not p_bf16 >= 40.0:
        fail(f'{preset} bf16 render PSNR {p_bf16} < 40 dB')

    res32 = 128
    img32 = pipe.render(*args, resolution=res32, precision='fp32')
    with reference_kernels():
        ref32 = pipe.render(*args, resolution=res32, precision='fp32')
    if not bool(torch.isfinite(img32).all()):
        fail(f'{preset} fp32 render has non-finite values')
    p_fp32 = psnr(ref32.cpu().numpy(), img32.cpu().numpy())
    print(f'render: {preset} fp32 {res32}^2 kernels vs plain HDR PSNR {p_fp32:.2f} dB '
          f'(need >= 55)', flush=True)
    if not p_fp32 >= 55.0:
        fail(f'{preset} fp32 render PSNR {p_fp32} < 55 dB')
    del ref, img32, ref32
    torch.cuda.empty_cache()

    # phase 5: speed, on inputs already on the card (as bench.py times it)
    dargs = tuple(torch.as_tensor(a, device='cuda') for a in args)
    rays = V * RES * RES
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.render(*dargs, resolution=RES, precision='bf16')
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    times = times[1:]  # the first render after the fp32 one is a warm-up
    med = statistics.median(times)
    print(f'speed: {preset} bf16 {RES}^2 x{V} views, {NTRI} tris, inputs on the card: '
          f'{rays / med:.1f} rays/s (median of {len(times)} renders, '
          f'{med * 1e3:.2f} ms; all {[round(x * 1e3, 2) for x in times]} ms) '
          f'on {card}', flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe.render(*dargs, resolution=RES, precision='bf16')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    for e in kernels[:25]:
        print(f'profile: {preset} {e.self_device_time_total / 1e3:9.3f} ms '
              f'{e.count:5d}x {e.key[:100]}', flush=True)
    # the profiler slows the host, so the idle share is read against the
    # median unprofiled render; the profiled wall time is printed beside it
    print(f'speed: {preset} device time {dev_ms:.2f} ms a render (profiled), device '
          f'idle share {1 - dev_ms / (med * 1e3):.3f} of the {med * 1e3:.2f} ms median '
          f'render ({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.2f} ms '
          f'profiled render)', flush=True)
    del pipe, dargs
    torch.cuda.empty_cache()
    return launches


def kernel_summary(rows, launches):
    """One entry a kernel: launches and times per render of each model,
    summed over the two models (bf16 rows; the fp32 rows are printed above)."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r['kernel'] == name and r['dtype'] == 'bfloat16']
        per = [sum(r['per_render'].values()) for r in mine]
        lib = [r['library_ms'] for r in mine]
        bms = sum(r['bound_ms'] * n for r, n in zip(mine, per))
        by_ops = sum(r['bound_ms'] * n for r, n in zip(mine, per)
                     if r['bound_by'] == 'operations')
        kernels.append(dict(
            name=name, **meta, launches=sum(launches[p][name] for p in PATHS),
            launches_by_path={p: launches[p][name] for p in PATHS},
            max_abs_err=max(r['max_abs_err'] for r in mine),
            ms=sum(r['ms'] * n for r, n in zip(mine, per)),
            ms_by_path={p: sum(r['ms'] * r['per_render'].get(p, 0) for r in mine)
                        for p in PATHS},
            plain_ms=sum(r['plain_ms'] * n for r, n in zip(mine, per)),
            bound_ms=bms, bound_by='operations' if by_ops * 2 > bms else 'bytes',
            library_ms=(None if any(x is None for x in lib) else
                        sum(x * n for x, n in zip(lib, per)))))
    return kernels


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this smoke run needs one GPU')
    if not os.path.isdir(os.path.join(HERE, 'renderformer_tpu_torch')):
        fail('renderformer_tpu_torch/ is not beside this script')
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f'card: {card}', flush=True)
    print(f'card: torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    from renderformer_tpu_torch import _build
    t = time.time()
    path = _build.build(verbose=True)
    _build.library()
    print(f'build: {path} in {time.time() - t:.1f} s', flush=True)

    rows = kernel_checks()
    launches = {preset: render_checks(card, preset) for preset in PATHS}
    for name in KERNELS:
        if not any(launches[p][name] for p in PATHS):
            fail(f'{name} was launched by no render')

    print(json.dumps({'kernels': kernel_summary(rows, launches)}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
