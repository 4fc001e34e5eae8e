#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (renderformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card: the nvidia-smi name and power limit, and torch's device name;
  2. build: compiles the kernels from renderformer_tpu_torch/csrc, and
     counts the wgmma (HGMMA) and TMA load (UTMALDG) instructions that
     cuobjdump finds in the bf16 flash forward's kernels (K1/K2, K10) and
     the bf16 flash backward's (K8, K9's dK/dV), which must both be
     non-zero, and the TF32 tensor-core instructions (HMMA .TF32) of the
     fp32 flash forward and of the fp32 dK/dV kernels of the flash backward
     (K8, K9's dK/dV), which must be non-zero, with the backward's and the
     fp32 kernels' spills and registers, and those of K11's backward and K5;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     every shape the v1-base, v1.1-swin-large and v1-base nerf 512^2 renders
     give it, in bf16 and fp32 (the flash forward without RoPE, K10, and the
     fused RMSNorm, K11, in the renders' bf16), with kernel, plain, library
     and bound times (CUDA events, median; K4 and K5 also by CUDA graphs of
     calls, beside F.interpolate's; K3 also by CUDA graphs of calls, beside
     its bytes bound; K11's forward and backward also by CUDA graphs, beside
     F.rms_norm's and its autograd's; K11's backward's ds in the scale's
     dtype is its checked fp32 sum rounded once, the same bits in two calls
     and three replays of a CUDA graph), the tile plan of the bf16 flash
     forward at each site, and the flash forward (K1/K2 and K10, with and
     without the logsumexp) at its tile edges: Sq and Sk of 129 and 257, a
     batch row whose mask is all zero, a view fan-out;
  4. render, for each of v1-base, v1.1-swin-large and v1-base nerf
     (V1_BASE_NERF, pe_type='nerf', with RuntimeConfig(fused_norm=True)) at
     full width and full depth from a seeded init, with the default composed
     DPT tail: 1 scene x 8 views x 2048 triangles at 512^2 in bf16 (the
     bench.py workload), with exact launch counts of every kernel (counts set
     to 0 just before the render, read just after), finite output, and HDR
     PSNR against the same render through the plain versions (>= 40 dB; an
     fp32 render at 128^2 must reach >= 55 dB);
  5. speed, for each model: rays/s of the bf16 render on inputs already on
     the card, median of timed renders, and a profiler breakdown of one
     render (device time by kernel, and the device's idle share of the
     median unprofiled render); for v1-base also, with no bar, rays/s of the
     render with fused_norm=True beside the default, timed in turn;
  6. training kernels: the forward with its logsumexp (K1/K2, timed in
     turn with the render's instantiation), K3 (also by CUDA graphs of
     calls), the flash backward's tile plan at each site (keys a block, q
     step, q split, blocks on the card's SMs), the flash backward through
     its wrapper (K8 fused; K9 two-kernel, each of its dQ and dK/dV kernels
     timed alone against the plain version of its part; K8 also by bursts
     of launches beside autograd of SDPA), K4, K5 and the
     transposed resize (K4^T) against their plain versions, at every shape
     of the v1-base train step, in bf16 and fp32, and K10 with its logsumexp
     and K11's forward and backward at the nerf train step's shapes and
     dtypes, timed as in phase 3, and the flash forward's tile edges of
     phase 3 with the logsumexp;
  7. train: v1-base at full width and depth from a seeded init, the
     train_step_bench.py workload (1 scene x 1 view x 2048 triangles at
     256^2, bf16 stage 1 with an fp32 view stage, remat, AdamW): exact launch
     counts of one step with the fused backward and one with the two-kernel
     backward (counts set to 0 just before each step, read just after); the
     loss, grad norm, gradient cosine and worst per-parameter gradient of the
     kernel step against the same step through the plain versions, and of
     fused against two-kernel, within AGREE_BARS, while a planted fault in
     the backward must fall outside them; finite
     loss and grad norm over 3 steps; the median step time of 5 steps after a
     warm-up, trained rays/s, peak memory, and the device's idle share from
     one profiled step.  Then the same workload for v1-base nerf with
     fused_norm=True and the fused backward: exact launch counts of one step,
     the kernel step against the plain step within AGREE_BARS, 3 finite
     steps, and the same timings.
Then one JSON line with every kernel's numbers per render of each model
and per train step, the nvidia-smi line, and the result line.  Any failed
check exits non-zero before the result line.  Imports nothing of JAX.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_TENSOR = 989e12   # H100 SXM dense bf16 tensor-core flop/s
PEAK_FP32 = 67e12           # H100 SXM fp32 flop/s outside the tensor cores
PEAK_TF32 = 494.7e12        # H100 SXM dense TF32 tensor-core flop/s
SPLIT_TF32 = PEAK_TF32 / 3  # fp32 products as split TF32: three TF32 products each
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
BASE, SWIN, NERF = 'v1-base', 'v1.1-swin-large', 'v1-base nerf'
PATHS = (BASE, SWIN, NERF)
# the train step at 256^2, 1 view, 2048 triangles: v1-base with the fused and
# the two-kernel backward, v1-base nerf with the fused backward and K11
TRAIN, TRAIN2, TRAIN_NERF = 'train v1-base', 'train v1-base twokernel', 'train v1-base nerf'
ROPE_TRAIN = (TRAIN, TRAIN2)
TRAIN_PATHS = (TRAIN, TRAIN2, TRAIN_NERF)
ALL_PATHS = PATHS + TRAIN_PATHS
TRAIN_RES = 256
TRAIN_ST = (TRAIN_RES // 8) ** 2   # 1024 ray tokens
TRAIN_STEPS = 5                    # timed steps after a warm-up
LSE_BURST = 20                     # launches per timing of the logsumexp A/B

BWD_SOURCES = ['renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
               'renderformer_tpu_torch/csrc/flash_bwd.cu']
KERNELS = {
    'flash_fwd_rope_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:876'),
    'flash_fwd_rope_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:888'),
    'rot_kv_broadcast': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/rot_kv.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:819'),
    # K8 and K9's dK/dV kernel: bf16 in flash_bwd_sm90.cu, fp32 in flash_bwd.cu
    'flash_bwd_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:425'),
    'flash_bwd_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:425'),
    'flash_bwd_dq': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:323'),
    'flash_bwd_dkv': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:368'),
    'resize_bilinear': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:100'),
    'resize_bilinear_t': dict(
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
    'flash_fwd_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:202'),
    'flash_fwd_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:217'),
    'rms_norm_fwd': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/fused_norm.cu',
        replaces='renderformer_tpu/ops/fused_norm.py:62'),
    'rms_norm_bwd': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/fused_norm.cu',
        replaces='renderformer_tpu/ops/fused_norm.py:73'),
}


def _launches(**nonzero):
    """A path's launch counts: every kernel of KERNELS, 0 unless given."""
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


# launches in one bf16 512^2 render with the composed DPT tail:
# v1-base: 12 encoder + 6 decoder masked attentions (K1), 6 ray
#   self-attentions (K2), a K rotation before each (K3), refinenet4/3/2
#   upsamples (K4), refinenet1's upsample into s2d layout (K5);
# swin-large: 12 encoder + 12 decoder masked attentions (K1, K3), window
#   attention in every decoder layer (K6), the regroup before and after it in
#   the 6 shifted layers (K7), and the same DPT head;
# v1-base nerf: the same attention sites without RoPE (K10 masked 12 + 6,
#   unmasked 6), the same DPT head, and with fused_norm=True K11 at each of the
#   102 RMSNorms: 3 stage-1 embeddings, 4 a self-attention block (query, q, k,
#   FFN), the ray encoder and the 2 position encodings of the view stage, 8 a
#   decoder block (query, context, cross q and k, self-attention input, q and
#   k, FFN).
# One v1-base train step with remat (each of the 24 attention sites runs K3
# and K1/K2 with the logsumexp in the forward, both again in the backward's
# recomputation, then K3 and the backward), the three K4 upsamples and K5 in
# the forward (the DPT head is not recomputed), and K4^T for the VJP of each.
# The nerf train step runs K10 with the logsumexp twice a site and K8 once,
# and K11's forward at the 102 norms plus again at the 96 inside the
# recomputed blocks, and its backward at the 102.
_TRAIN = dict(flash_fwd_rope_mask=36, flash_fwd_rope_nomask=12, rot_kv_broadcast=72,
              resize_bilinear=3, resize_bilinear_t=4, resize_s2d=1)
EXPECTED_LAUNCHES = {
    BASE: _launches(flash_fwd_rope_mask=18, flash_fwd_rope_nomask=6, rot_kv_broadcast=24,
                    resize_bilinear=3, resize_s2d=1),
    SWIN: _launches(flash_fwd_rope_mask=24, rot_kv_broadcast=24, resize_bilinear=3,
                    resize_s2d=1, swin_window_attention=12, shifted_regroup=12),
    NERF: _launches(flash_fwd_mask=18, flash_fwd_nomask=6, resize_bilinear=3, resize_s2d=1,
                    rms_norm_fwd=102),
    TRAIN: _launches(**_TRAIN, flash_bwd_mask=18, flash_bwd_nomask=6),
    TRAIN2: _launches(**_TRAIN, flash_bwd_dq=24, flash_bwd_dkv=24),
    TRAIN_NERF: _launches(flash_fwd_mask=36, flash_fwd_nomask=12, flash_bwd_mask=18,
                          flash_bwd_nomask=6, resize_bilinear=3, resize_bilinear_t=4,
                          resize_s2d=1, rms_norm_fwd=198, rms_norm_bwd=102),
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


def graph_burst_ms(fn, n=LSE_BURST, iters=10, side=None):
    """Device milliseconds a call of fn() takes: replays of a CUDA graph of n
    calls between two CUDA events, divided by n, so that no host work sits
    between the launches.  fn is warmed up and captured on ``side`` (a new
    stream by default)."""
    import torch
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the stream that warmed fn up
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, iters=iters) / n
    del graph
    return ms


def graph_replays(fn, n):
    """fn()'s results after each of n replays of a CUDA graph of one call
    (cloned), the call warmed up and captured on a stream of its own."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    results = []
    for _ in range(n):
        graph.replay()
        torch.cuda.synchronize()
        results.append(tuple(t.clone() for t in out))
    del graph
    return results


def autograd_graph_ms(forward, inputs, grad_out, n=LSE_BURST, iters=10):
    """Device milliseconds of one torch.autograd.grad of ``forward(*inputs)``
    for ``grad_out``, as graph_burst_ms times a call: the forward runs once
    on the capturing stream, so that autograd's backward launches there."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = forward(*leaves)
    ms = graph_burst_ms(lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True),
                        n, iters, side)
    del out, leaves
    return ms


def burst_ms(fn, n=LSE_BURST):
    """Milliseconds a call of fn() in bursts of n back-to-back calls between
    two CUDA events, divided by n: the device time where the card outruns
    the host's enqueue."""
    return time_ms(lambda: [fn() for _ in range(n)]) / n


def print_profile(name, kernels):
    """The 25 largest device rows of a profiled run, and below them the rows
    of the resize (K4, K5, K4^T) and fused RMSNorm (K11) kernels."""
    for i, e in enumerate(kernels):
        if i < 25 or 'resize' in e.key or 'rms_norm' in e.key:
            print(f'profile: {name} {e.self_device_time_total / 1e3:9.3f} ms '
                  f'{e.count:5d}x {e.key[:100]}', flush=True)


def psnr(ref, x):
    mse = float(((ref - x) ** 2).mean())
    peak = float(ref.max() - ref.min())
    return 10 * np.log10(peak ** 2 / max(mse, 1e-30))


def record_row(rows, kernel, site, dtype, per_run, out, ref, tol, why, fn, lib_fn, nbytes,
               flops, flop_rate, plain_fn=None):
    """Check one (kernel, site, dtype) and time fn as the kernel and plain_fn
    (default: fn inside reference_kernels()) as the plain version.  out, ref
    and tol may be tuples, checked pair by pair.  per_run: launches at this
    shape and dtype in one run of each path."""
    from renderformer_tpu_torch.ops import reference_kernels
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    tols = tol if isinstance(tol, tuple) else (tol,) * len(outs)
    errs = [float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs)]
    ms = time_ms(fn)
    if plain_fn is None:
        with reference_kernels():
            plain_ms = time_ms(fn, iters=3, warmup=1)
    else:
        plain_ms = time_ms(plain_fn, iters=3, warmup=1)
    lib_ms = time_ms(lib_fn) if lib_fn is not None else None
    bms, by = bound_ms(nbytes, flops, flop_rate)
    row = dict(kernel=kernel, site=site, dtype=str(dtype).split('.')[-1], per_run=per_run,
               max_abs_err=max(errs), errs=errs, tol=list(tols), tol_reason=why, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
    if flop_rate == SPLIT_TF32:
        # the fp32 flash forward: its bound as split TF32 on the tensor cores,
        # and beside it the bound of the same flops as scalar fp32 FMAs
        row['bound_simt_ms'] = bound_ms(nbytes, flops, PEAK_FP32)[0]
    row['bound_share'] = bms / ms
    print('kernel ' + json.dumps(row), flush=True)
    for e, t in zip(errs, tols):
        if not np.isfinite(e) or e > t:
            fail(f'{kernel} {site} {row["dtype"]}: max err {e} > {t}')
    if bms > ms:
        fail(f'{kernel} {site} {row["dtype"]}: {ms} ms beats its bound {bms} ms ({by})')
    rows.append(row)


def attention_tol(ref, dtype, what):
    """Output-scaled tolerance of the attention kernels (K1, K2, K6)."""
    import torch
    amax = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return amax * 4 * 2.0 ** -8, (
            f'q and P round to bf16 in both, {what}, and out rounds once to '
            'bf16: 4 ulps of max|ref|')
    return amax * 2.0 ** -16, 'fp32 sums in another order: 2^-16 of max|ref|'


def check_resize(rows, x, hw, per_run):
    """K4 on x [B, n, n, C] to hw against its plain version."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear
    b, n_in, _, c = x.shape
    it = x.element_size()
    with torch.inference_mode():
        out = resize_bilinear(x, hw)
        with reference_kernels():
            ref = resize_bilinear(x, hw)
        amax = float(x.float().abs().max())
        if x.dtype == torch.bfloat16:
            tol, why = amax * 2.0 ** -5, ('the plain version rounds frac, 1-frac and each '
                                          'lerp to bf16; the kernel rounds once: 4 ulps of '
                                          'max|x|')
        else:
            tol, why = amax * 2.0 ** -22, 'same fp32 ops in the same order'
        xc = x.permute(0, 3, 1, 2)

        def lib():
            return F.interpolate(xc, size=hw, mode='bilinear', align_corners=True)

        record_row(rows, 'resize_bilinear', f'{n_in}to{hw[0]}', x.dtype, per_run, out, ref,
                   tol, why, lambda: resize_bilinear(x, hw), lib,
                   b * (n_in * n_in + hw[0] * hw[1]) * c * it, 8 * b * hw[0] * hw[1] * c,
                   PEAK_FP32)
        # host and device apart: the single call holds the host's enqueue
        # where the card waits for it; a graph of LSE_BURST calls does not
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: resize_bilinear(x, hw))
        row['library_burst_ms'] = graph_burst_ms(lib)
        print(f'resize: resize_bilinear {row["site"]} {row["dtype"]}: single call '
              f'{row["ms"]:.4f} ms against F.interpolate {row["library_ms"]:.4f}; device (graph '
              f'of {LSE_BURST}) {row["burst_ms"]:.4f} ms a call against '
              f'{row["library_burst_ms"]:.4f} (bound {row["bound_ms"]:.4f})', flush=True)


def check_resize_s2d(rows, x, hw, per_run):
    """K5 on x [B, n, n, C] to hw in s2d layout against its plain version."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_resize import resize_s2d
    from renderformer_tpu_torch.ops.s2d_conv import space_to_depth
    b, n_in, _, c = x.shape
    it = x.element_size()
    with torch.inference_mode():
        out = resize_s2d(x, hw)
        with reference_kernels():
            ref = resize_s2d(x, hw)
        xc = x.permute(0, 3, 1, 2)
        record_row(rows, 'resize_s2d', f'{n_in}to{hw[0]}_s2d', x.dtype, per_run,
                   out, ref, 0.0, 'the plain resize in fp32 rounded once, then '
                   'space_to_depth: the same ops in the same order, bit for bit',
                   lambda: resize_s2d(x, hw),
                   lambda: space_to_depth(F.interpolate(
                       xc, size=hw, mode='bilinear', align_corners=True
                   ).permute(0, 2, 3, 1)),
                   b * (n_in * n_in + hw[0] * hw[1]) * c * it, 8 * b * hw[0] * hw[1] * c,
                   PEAK_FP32)
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: resize_s2d(x, hw))
        row['library_burst_ms'] = graph_burst_ms(lambda: space_to_depth(F.interpolate(
            xc, size=hw, mode='bilinear', align_corners=True).permute(0, 2, 3, 1)))
        print(f'resize: resize_s2d {row["site"]} {row["dtype"]}: single call {row["ms"]:.4f} ms '
              f'against F.interpolate + space_to_depth {row["library_ms"]:.4f}; device (graph of '
              f'{LSE_BURST}) {row["burst_ms"]:.4f} ms a call against '
              f'{row["library_burst_ms"]:.4f} (bound {row["bound_ms"]:.4f}: '
              f'{row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)


def k3_bytes(b, bkv, sk, h, it):
    """K3 reads k at the scene batch and the fp32 tables, writes k at the q batch."""
    return bkv * sk * h * D * it + 2 * b * sk * D * 4 + b * sk * h * D * it


K3_WHY = ('same fp32 arithmetic as the plain version; one ulp of the largest output for '
          'a differently rounded product')


def k3_burst(rows, fn):
    """K3's device time at the last row's site: a CUDA graph of LSE_BURST
    calls, against its bytes bound."""
    row = rows[-1]
    row['burst_ms'] = graph_burst_ms(fn)
    print(f'k3: rot_kv_broadcast {row["site"]} {row["dtype"]}: device (graph of {LSE_BURST}) '
          f'{row["burst_ms"]:.5f} ms a call against its bytes bound {row["bound_ms"]:.5f} '
          f'({row["bound_ms"] / row["burst_ms"]:.3f} of it); single call {row["ms"]:.4f}',
          flush=True)


def k3_tol(ref):
    import torch
    return float(ref.float().abs().max()) * (2.0 ** -7 if ref.dtype == torch.bfloat16
                                             else 2.0 ** -22)


NORM_D = 768  # the model width of v1-base, the width of every K11 site

# the flash forward at its tile edges, bf16 (csrc/flash_fwd_sm90.cu) and fp32
# (csrc/flash_attention.cu, 64-row q tiles, 32-key tiles, keys split across
# a cluster where the grid is small): name, B, Bkv, Sq, Sk, H, masked; a
# masked case with B > 1 zeroes batch row 1's mask.  Sq and Sk are not
# multiples of 32, 64 or 128; the last case is the swin-large
# cross-attention's head count and fan-out at a small length.
FLASH_EDGES = [
    ('edge_129x257_reps2', 2, 1, 129, 257, 2, True),
    ('edge_257x129', 1, 1, 257, 129, 2, False),
    ('edge_129x129_zero_row', 3, 3, 129, 129, 1, True),
    ('edge_257x257_h8_reps8', 8, 1, 257, 257, 8, True),
]
SASS_KERNEL = 'flash_fwd_sm90_kernel'
SASS_F32_KERNEL = 'flash_fwd_f32_kernel'
SASS_BWD_KERNEL = 'flash_bwd_kv_kernel'
SASS_BWD_BF16_KERNEL = 'flash_bwd_sm90_kernel'


def flash_rate(dtype):
    """The flop rate of the flash forward's bound: bf16 tensor cores, or
    split TF32 for fp32."""
    import torch
    return PEAK_BF16_TENSOR if dtype == torch.bfloat16 else SPLIT_TF32


def sass_counts(sass, kernel, ops):
    """{instantiation of ``kernel``: {op: lines of its SASS holding every
    word of op}} from cuobjdump's output."""
    counts, cur = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            cur = name[name.index(kernel) + len(kernel):][:40] if kernel in name else None
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur:
            for op in ops:
                counts[cur][op] += all(w in line for w in op.split())
    return counts


def res_usage(lib_path, kernel):
    """{instantiation of ``kernel``: 'REG:.. STACK:.. LOCAL:..'} by cuobjdump
    -res-usage."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([cuobjdump, '-res-usage', lib_path], capture_output=True, text=True,
                         timeout=300)
    usage, cur = {}, None
    for line in res.stdout.splitlines():
        if 'Function ' in line:
            name = line.split('Function ', 1)[1].strip().rstrip(':')
            cur = name[name.index(kernel) + len(kernel):][:40] if kernel in name else None
        elif cur and 'REG:' in line:
            usage[cur] = ' '.join(w for w in line.split() if w.split(':')[0] in
                                  ('REG', 'STACK', 'LOCAL', 'SHARED'))
            cur = None
    return usage


def sass_check(lib_path):
    """Phase 2: HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    of the bf16 flash forward's kernels and of the bf16 flash backward's
    (K8, and K9's dK/dV), and TF32 HMMA (mma.sync on the tensor cores) in
    each of the fp32 flash forward's and in each fp32 instantiation of the
    flash backward's dK/dV kernel, by cuobjdump; fails unless every one has
    them.  Spills (local loads and stores) and registers of the backward
    and the fp32 kernels, and of K11's backward and K5, are printed beside
    them."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True,
                         timeout=300)
    if res.returncode:
        fail(f'cuobjdump: {res.stderr.strip()[:500]}')
    # each instantiation must hold the ops of ``need``; local-memory loads
    # and stores (spills) of the fp32 kernels are counted beside them
    for kernel, what, need, seen, only in (
            (SASS_KERNEL, 'bf16 flash forward', ('HGMMA', 'UTMALDG'), (), ''),
            (SASS_BWD_BF16_KERNEL, 'bf16 flash backward', ('HGMMA', 'UTMALDG'), ('LDL', 'STL'),
             ''),
            (SASS_F32_KERNEL, 'fp32 flash forward', ('HMMA TF32',), ('LDL', 'STL'), ''),
            (SASS_BWD_KERNEL, 'fp32 flash backward dK/dV', ('HMMA TF32',), ('LDL', 'STL'),
             'If'),
            ('rms_norm_bwd_kernel', 'fused RMSNorm backward (K11)', (), ('LDL', 'STL'), ''),
            ('resize_s2d_kernel', 'space-to-depth resize (K5)', (), ('LDL', 'STL'), '')):
        counts = {k: c for k, c in sass_counts(res.stdout, kernel, need + seen).items()
                  if k.startswith(only)}
        print(f'build: sass of {len(counts)} {what} kernels ({kernel}): '
              + ', '.join(f'{op} {sum(c[op] for c in counts.values())}' for op in need + seen)
              + '; ' + json.dumps(counts), flush=True)
        if seen:
            usage = {k: u for k, u in res_usage(lib_path, kernel).items() if k.startswith(only)}
            print(f'build: resources of the {what} kernels: {json.dumps(usage)}', flush=True)
        if not counts or any(not c[op] for c in counts.values() for op in need):
            fail(f'the {what} kernels lack {need}: {counts}')


def print_plan(kernel, site, b, sq, h, dtype=None, sk=None):
    """The tile plan the flash forward takes at a main-path site: the bf16
    kernel's q rows a block; the fp32 kernel's 64 rows and key split (blocks
    of a cluster that share a q tile's keys)."""
    import torch
    from renderformer_tpu_torch.ops.flash_attention import flash_fwd_rows, flash_fwd_splits
    dtype = dtype or torch.bfloat16
    rows = flash_fwd_rows(dtype, b, sq, h)
    splits = flash_fwd_splits(dtype, b, sq, sk or sq, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f'plan: {kernel} {site} {str(dtype).split(".")[-1]} B {b} x H {h} x Sq {sq}: {rows} '
          f'q rows a block, keys split {splits} ways, {-(-sq // rows) * h * b * splits} '
          f'blocks on {sms} SMs', flush=True)


def check_flash_edges(rows, randn, tables, with_lse, dtype):
    """K1/K2 (on K rotated by K3) and K10 in ``dtype`` (bf16 or fp32)
    at FLASH_EDGES against their plain versions; the logsumexp of a row
    whose keys are all masked (m = -1e30) is left out of the logsumexp
    comparison, its output (uniform over the keys) is not."""
    import torch
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        fan_out, flash_fwd, flash_fwd_rope, rot_kv_broadcast)
    it = 2 if dtype == torch.bfloat16 else 4
    for name, b, bkv, sq, sk, h, masked in FLASH_EDGES:
        q = randn(b, sq, h, D, dtype=dtype)
        k, v = randn(bkv, sk, h, D, dtype=dtype), randn(bkv, sk, h, D, dtype=dtype)
        cq, sq_t = tables(b, sq)
        ck, sk_t = tables(b, sk)
        mask, keep = None, list(range(b))
        if masked:
            mask = randn(b, sk) > -0.5
            mask[:, 0] = True
            if b > 1:
                mask[1] = False
                keep.remove(1)
        kb, vb = fan_out(k, b).contiguous(), fan_out(v, b).contiguous()
        with torch.no_grad():
            k_rot = rot_kv_broadcast(k, ck, sk_t)
            for kname, fn in (
                    ('flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask',
                     lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=with_lse)),
                    ('flash_fwd_mask' if masked else 'flash_fwd_nomask',
                     lambda: flash_fwd(q, kb, vb, mask, with_lse=with_lse))):
                out = fn()
                with reference_kernels():
                    ref = fn()
                tol, why = attention_tol(ref[0] if with_lse else ref, dtype,
                                         'P at the running max vs the row max')
                if with_lse:
                    out, ref = (out[0], out[1][keep]), (ref[0], ref[1][keep])
                    tol = (tol, 1e-5 * float(ref[1].abs().max()) + 2e-5)
                    why += '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5'
                record_row(rows, kname, name + ('_lse' if with_lse else ''), dtype, {}, out, ref,
                           tol, why, fn, None,
                           (2 * b * sq + 2 * b * sk) * h * D * it + (b * sk if masked else 0),
                           4 * b * h * sq * sk * D, flash_rate(dtype))
        del q, k, v, kb, vb, k_rot, out, ref


def check_flash_fwd(rows, randn, site, b, sq, sk, masked, dtype, per_run, with_lse=False):
    """K10 at q [b, sq, 6, D] against k, v [b, sk, 6, D] (a padded tail of
    triangles masked) against its plain version; SDPA with the boolean key
    mask, or none, is the library yardstick."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import flash_fwd
    H = 6
    it = 2 if dtype == torch.bfloat16 else 4
    q = randn(b, sq, H, D, dtype=dtype)
    k, v = randn(b, sk, H, D, dtype=dtype), randn(b, sk, H, D, dtype=dtype)
    mask = None
    if masked:
        mask = torch.ones(b, sk, dtype=torch.bool, device=q.device)
        mask[:, 16 + NTRI * 3 // 4:] = False
    with torch.no_grad():
        out = flash_fwd(q, k, v, mask, with_lse=with_lse)
        with reference_kernels():
            ref = flash_fwd(q, k, v, mask, with_lse=with_lse)
        ref_out = ref[0] if with_lse else ref
        tol, why = attention_tol(ref_out, dtype, 'P at the running max vs the row max')
        if with_lse:
            tol = (tol, 1e-5 * float(ref[1].abs().max()) + 2e-5)
            why += '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5'
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = mask[:, None, None, :] if masked else None
        record_row(rows, 'flash_fwd_mask' if masked else 'flash_fwd_nomask',
                   site + ('_lse' if with_lse else ''), dtype, per_run, out, ref, tol, why,
                   lambda: flash_fwd(q, k, v, mask, with_lse=with_lse),
                   lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                   (2 * b * sq + 2 * b * sk) * H * D * it + (b * sk if masked else 0)
                   + (b * H * sq * 4 if with_lse else 0),
                   4 * b * H * sq * sk * D, flash_rate(dtype))
    del q, k, v, out, ref, qs, ks, vs
    torch.cuda.empty_cache()


def ulp_tol(ref):
    """One bf16 ulp of max|ref| (2^-7 of its binade); fp32: 2^-20 of max|ref|."""
    import torch
    amax = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(amax)) - 7)
    return amax * 2.0 ** -20


def check_rms_norm(rows, randn, site, r, dtype, eps, per_fwd, per_bwd):
    """K11's forward and backward at x [r, 768] against their plain versions;
    torch.nn.functional.rms_norm and its autograd are the library
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_norm import rms_norm_bwd, rms_norm_fwd
    it = 2 if dtype == torch.bfloat16 else 4
    x, g = randn(r, NORM_D, dtype=dtype), randn(r, NORM_D, dtype=dtype)
    scale = 1 + 0.1 * randn(NORM_D)
    why = ('the same arithmetic, inv from a sum of squares in another order, which can '
           'round bf16(inv) to its other neighbour: 1 bf16 ulp of max|ref|, fp32 2^-20 of it')
    ws = scale.to(dtype)  # the paths hand K11 the scale in x's dtype
    with torch.no_grad():
        y = rms_norm_fwd(x, ws, eps)
        with reference_kernels():
            ref = rms_norm_fwd(x, ws, eps)
        record_row(rows, 'rms_norm_fwd', site, dtype, per_fwd, y, ref, ulp_tol(ref), why,
                   lambda: rms_norm_fwd(x, ws, eps),
                   lambda: F.rms_norm(x, (NORM_D,), ws, eps),
                   2 * r * NORM_D * it + NORM_D * ws.element_size(), 4 * r * NORM_D,
                   PEAK_FP32)
        # host and device apart: the single call above holds the host's work
        # where the card waits for it; a graph of LSE_BURST calls does not
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: rms_norm_fwd(x, ws, eps))
        row['library_burst_ms'] = graph_burst_ms(lambda: F.rms_norm(x, (NORM_D,), ws, eps))
        print(f'norm: rms_norm_fwd {site} {row["dtype"]} scale {row["dtype"]}: single call '
              f'{row["ms"]:.4f} ms against F.rms_norm {row["library_ms"]:.4f}; device (graph of '
              f'{LSE_BURST}) {row["burst_ms"]:.4f} ms a call against {row["library_burst_ms"]:.4f}'
              f' (bound {row["bound_ms"]:.4f})', flush=True)
        # checked with the scale's fp32 cast, whose ds is an fp32 sum, against
        # the plain version's; the path's call writes ds in the scale's dtype:
        # that sum rounded once, the same bits in every call and in every
        # replay of a CUDA graph
        got = rms_norm_bwd(x, ws.float(), g, eps)
        with reference_kernels():
            ref = rms_norm_bwd(x, ws.float(), g, eps)
        calls = [rms_norm_bwd(x, ws, g, eps) for _ in range(2)]
        calls += graph_replays(lambda: rms_norm_bwd(x, ws, g, eps), 3)
        for dxc, dsc in calls:
            if not (dsc.dtype == ws.dtype and torch.equal(dsc, got[1].to(ws.dtype))
                    and torch.equal(dxc, got[0])):
                fail(f'rms_norm_bwd {site}: a call or graph replay differs from the checked '
                     'call, or ds is not its fp32 sum rounded to the scale\'s dtype')
    xl, wl = x.detach().clone().requires_grad_(True), ws.detach().clone().requires_grad_(True)
    yl = F.rms_norm(xl, (NORM_D,), wl, eps)
    with torch.no_grad():
        record_row(rows, 'rms_norm_bwd', site, dtype, per_bwd, got, ref,
                   (ulp_tol(ref[0]), 1e-5 * float(ref[1].abs().max())),
                   why + '; ds: sums over warps, blocks and clusters against one sum over the '
                   'rows, 1e-5 of max|ds|',
                   lambda: rms_norm_bwd(x, ws, g, eps),
                   lambda: torch.autograd.grad(yl, (xl, wl), g, retain_graph=True),
                   3 * r * NORM_D * it + 2 * NORM_D * ws.element_size(), 10 * r * NORM_D,
                   PEAK_FP32)
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: rms_norm_bwd(x, ws, g, eps))
    row['library_burst_ms'] = autograd_graph_ms(
        lambda a, w: F.rms_norm(a, (NORM_D,), w, eps), (x, ws), g)
    print(f'norm: rms_norm_bwd {site} {row["dtype"]} scale {row["dtype"]}: single call '
          f'{row["ms"]:.4f} ms against autograd of F.rms_norm {row["library_ms"]:.4f}; device '
          f'(graph of {LSE_BURST}) {row["burst_ms"]:.5f} ms a call against '
          f'{row["library_burst_ms"]:.5f} (bound {row["bound_ms"]:.5f}: '
          f'{row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)
    del x, g, y, ref, got, xl, wl, yl
    torch.cuda.empty_cache()


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

    def record(kernel, site, dtype, per_render, *args):
        # the renders run bf16: an fp32 row is checked and timed, launched by no path
        record_row(rows, kernel, site, dtype, per_render if dtype == torch.bfloat16 else {},
                   *args)

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
            print_plan('flash_fwd_rope', site, b, sq, H, dtype, sk)
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
                record('rot_kv_broadcast', site, dtype, n, out, ref, k3_tol(ref), K3_WHY,
                       lambda: rot_kv_broadcast(k, ck, sk_t), None,
                       k3_bytes(b, bkv, sk, H, it), 3 * b * sk * H * D, PEAK_FP32)
                k3_burst(rows, lambda: rot_kv_broadcast(k, ck, sk_t))
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
                       4 * b * H * sq * sk * D, flash_rate(dtype))
            del q, k, v, k_rot, out, ref, qr, qs, ks, vs
            torch.cuda.empty_cache()

        # K4: refinenet4/3/2 upsamples of both DPT heads; K5: refinenet1's
        # upsample into s2d layout, the composed tail's input
        per_render = {BASE: 1, SWIN: 1, NERF: 1} if dtype == torch.bfloat16 else {}
        for n_in in (32, 64, 128):
            check_resize(rows, randn(V, n_in, n_in, DPT_C, dtype=dtype), (2 * n_in, 2 * n_in),
                         per_render)
        check_resize_s2d(rows, randn(V, RES // 2, RES // 2, DPT_C, dtype=dtype), (RES, RES),
                         per_render)
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

    # K10 and K11 at the v1-base nerf render's shapes, in its bf16
    bf = torch.bfloat16
    for site, b, sq, sk, masked, n in (('nerf_stage1_self', 1, SK, SK, True, 12),
                                       ('nerf_cross', V, ST, SK, True, 6),
                                       ('nerf_ray_self', V, ST, ST, False, 6)):
        print_plan('flash_fwd', site, b, sq, 6)
        check_flash_fwd(rows, randn, site, b, sq, sk, masked, bf, {NERF: n})
    for dtype in (bf, torch.float32):
        check_flash_edges(rows, randn, tables, False, dtype)
    eps_tiny = float(np.finfo(np.float32).eps)  # torch's RMSNorm default
    for site, r, eps, n in (('embed_2048', NTRI, eps_tiny, 3), ('stage1_2064', SK, 1e-6, 48),
                            ('rays_8x4096', V * ST, 1e-6, 38), ('tris_8x2064', V * SK, 1e-6, 13)):
        check_rms_norm(rows, randn, site, r, bf, eps, {NERF: n}, {})
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


def render_pipeline(path):
    """The seeded pipeline of a render path: the presets as they are, and
    V1_BASE_NERF with the fused RMSNorm."""
    from renderformer_tpu_torch import V1_BASE_NERF, RenderingPipeline, RuntimeConfig
    if path == NERF:
        return RenderingPipeline.from_config(V1_BASE_NERF, seed=0,
                                             runtime=RuntimeConfig(fused_norm=True))
    return RenderingPipeline.from_pretrained(path, seed=0)


def time_render(pipe, dargs):
    """Host seconds of one bf16 render on inputs on the card."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe.render(*dargs, resolution=RES, precision='bf16')
    torch.cuda.synchronize()
    return time.perf_counter() - t


def fused_norm_ab(card, pipe, dargs):
    """Informational, no bar: rays/s of the v1-base render with
    fused_norm=True beside the default on the same model, timed in turn."""
    from renderformer_tpu_torch import RenderingPipeline, RuntimeConfig
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    fused = RenderingPipeline(pipe.model, runtime=RuntimeConfig(fused_norm=True))
    reset_launch_counts()
    time_render(fused, dargs)  # warm-up, and its K11 launches
    n_norm = LAUNCHES['rms_norm_fwd']
    turns = [(time_render(pipe, dargs), time_render(fused, dargs)) for _ in range(5)]
    default, with_k11 = (statistics.median(x) for x in zip(*turns))
    rays = V * RES * RES
    print(f'speed: {BASE} bf16 {RES}^2 fused_norm=True (informational, no bar): '
          f'{rays / with_k11:.1f} rays/s ({with_k11 * 1e3:.2f} ms, {n_norm} K11 launches) '
          f'against the default {rays / default:.1f} rays/s ({default * 1e3:.2f} ms), medians '
          f'of 5 turns {[(round(a * 1e3, 2), round(b * 1e3, 2)) for a, b in turns]} ms, '
          f'on {card}', flush=True)
    del fused


def render_checks(card, preset):
    """Phases 4 and 5 for one model; returns its launch counts and the
    median render time."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels, reset_launch_counts

    t0 = time.time()
    pipe = render_pipeline(preset)
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
    times = [time_render(pipe, dargs) for _ in range(6)]
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
    print_profile(preset, kernels)
    # the profiler slows the host, so the idle share is read against the
    # median unprofiled render; the profiled wall time is printed beside it
    print(f'speed: {preset} device time {dev_ms:.2f} ms a render (profiled), device '
          f'idle share {1 - dev_ms / (med * 1e3):.3f} of the {med * 1e3:.2f} ms median '
          f'render ({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.2f} ms '
          f'profiled render)', flush=True)
    if preset == BASE:
        fused_norm_ab(card, pipe, dargs)
    del pipe, dargs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def train_kernel_checks():
    """The forward's logsumexp (K1/K2), K3, K8, K9's two kernels, K4, K5 and
    K4^T at the v1-base train step's shapes, in bf16 and fp32, and K10 with
    its logsumexp and K11 at the nerf train step's shapes in the dtypes it
    runs them; per_run counts the launches at the dtype the step runs there
    (bf16 stage 1, fp32 view stage) in one step of each path that launches
    the kernel (K8's shapes are the same in the nerf step)."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_bwd_keys, flash_bwd_splits,
        flash_fwd_rope, launch_flash_bwd, launch_flash_fwd_rope, rot_kv_broadcast,
        rot_kv_broadcast_plain)
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear_t

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    lib = _build.library()
    rows = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def tables(b, s):
        c, sn = make_cos_sin(randn(b, s, 9) * 0.3, rope_dim=12, head_dim=D)
        return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()

    H = 6
    sites = [  # name, Sq, Sk, masked, dtype of the step there, sites a step
        ('train_stage1_self', SK, SK, True, torch.bfloat16, 12),
        ('train_cross', TRAIN_ST, SK, True, torch.float32, 6),
        ('train_ray_self', TRAIN_ST, TRAIN_ST, False, torch.float32, 6),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        it = 2 if dtype == torch.bfloat16 else 4
        for site, sq, sk, masked, step_dtype, n in sites:
            if dtype == step_dtype:
                print_plan('flash_fwd_rope', site, 1, sq, H, dtype, sk)
                splits = flash_bwd_splits(dtype, 1, sq, sk, H)
                keys = flash_bwd_keys(dtype)
                step = ('64 q rows a step, in halves of 32' if dtype == torch.bfloat16
                        else '16 q rows a step')
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                print(f'plan: flash_bwd {site} {str(dtype).split(".")[-1]} B 1 x H {H} x Sk '
                      f'{sk}: {keys} keys a block, {step}, q steps split {splits} ways, '
                      f'{-(-sk // keys) * H * splits} blocks on {sms} SMs', flush=True)

            def per_step(k, paths=ROPE_TRAIN):
                return {p: k * n for p in paths} if dtype == step_dtype else {}
            q, do = randn(1, sq, H, D, dtype=dtype), randn(1, sq, H, D, dtype=dtype)
            k, v = randn(1, sk, H, D, dtype=dtype), randn(1, sk, H, D, dtype=dtype)
            cq, sq_t = tables(1, sq)
            ck, sk_t = (cq, sq_t) if sq == sk else tables(1, sk)
            mask = None
            if masked:
                mask = torch.ones(1, sk, dtype=torch.bool, device=dev)
                mask[:, 16 + NTRI * 3 // 4:] = False
            with torch.no_grad():
                # K3: three times a step (forward, remat recompute, backward)
                k_rot = rot_kv_broadcast(k, ck, sk_t)
                ref_rot = rot_kv_broadcast_plain(k, ck, sk_t)
                record_row(rows, 'rot_kv_broadcast', site, dtype, per_step(3), k_rot, ref_rot,
                           k3_tol(ref_rot), K3_WHY, lambda: rot_kv_broadcast(k, ck, sk_t), None,
                           k3_bytes(1, 1, sk, H, it), 3 * sk * H * D, PEAK_FP32)
                k3_burst(rows, lambda: rot_kv_broadcast(k, ck, sk_t))
                # K1/K2 with the logsumexp: twice a step (forward, remat recompute)
                kname = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
                out, lse = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=True)
                with reference_kernels():
                    ref_out, ref_lse = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t,
                                                      with_lse=True)
                tol, why = attention_tol(ref_out, dtype, 'P at the running max vs the row max')
                lse_tol = 1e-5 * float(ref_lse.abs().max()) + 2e-5
                qs, ks = (rot_kv_broadcast_plain(q, cq, sq_t).transpose(1, 2).contiguous(),
                          k_rot.transpose(1, 2).contiguous())
                vs = v.transpose(1, 2).contiguous()
                am = mask[:, None, None, :] if mask is not None else None
                fwd_bytes = (2 * sq + 2 * sk) * H * D * it + (sk if masked else 0) \
                    + 2 * sq * D * 4 + H * sq * 4
                record_row(rows, kname, site + '_lse', dtype, per_step(2), (out, lse),
                           (ref_out, ref_lse), (tol, lse_tol),
                           why + '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5',
                           lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=True),
                           lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                           fwd_bytes, 4 * H * sq * sk * D, flash_rate(dtype))
                # what the logsumexp costs: against the render's instantiation on
                # the same inputs, the two timed in turn three times, each as
                # bursts of LSE_BURST launches into buffers made beforehand, so
                # that neither the host nor an allocation sits between them
                lse_buf = torch.empty_like(lse)

                def burst(buf):
                    return lambda: [launch_flash_fwd_rope(lib, q, k_rot, v, mask, cq, sq_t, buf)
                                    for _ in range(LSE_BURST)]

                pairs = [(time_ms(burst(lse_buf)) / LSE_BURST, time_ms(burst(None)) / LSE_BURST)
                         for _ in range(3)]
                w, wo = (statistics.median(x) for x in zip(*pairs))
                print(f'lse: {kname} {site} {rows[-1]["dtype"]}: {w:.4f} ms a launch with the '
                      f'logsumexp, {wo:.4f} ms without ({w / wo - 1:+.3f}), medians of the '
                      f'turns {[(round(a, 4), round(b, 4)) for a, b in pairs]}', flush=True)
                lse = ref_lse
                delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
                io = (q, k_rot, v, mask, lse, delta, do)
                with reference_kernels():
                    ref = flash_bwd(*io)
                tols = tuple(attention_tol(r, dtype, '')[0] * 2 for r in ref)
                why = ('q, P and dS round to the dtype in both, dQ sums by atomics (K8) in a '
                       'run-dependent order: 8 bf16 ulps / 2^-15 of max|ref| per output')
            # library yardsticks: autograd through SDPA on the same inputs, for
            # all three gradients (K8), dq alone and (dk, dv) alone (K9's kernels)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qs, ks, vs))
            yl = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am)
            gl = do.transpose(1, 2).contiguous()

            def lib_grad(*wrt):
                return lambda: torch.autograd.grad(yl, wrt, gl, retain_graph=True)

            b_in = (2 * sq + 2 * sk) * H * D * it + 2 * H * sq * 4 + (sk if masked else 0)
            b_out_kv, b_out_q = 2 * sk * H * D * it, sq * H * D * it
            with torch.no_grad():
                # the wrappers the train step calls are checked; K9's kernels are
                # timed one at a time, each against the plain version of its part
                fused = flash_bwd(*io, 'fused')
                record_row(rows, 'flash_bwd_mask' if masked else 'flash_bwd_nomask', site, dtype,
                           per_step(1, (TRAIN, TRAIN_NERF)), fused, ref, tols, why,
                           lambda: flash_bwd(*io, 'fused'), lib_grad(ql, kl, vl),
                           b_in + sq * H * D * it + b_out_kv + b_out_q,
                           10 * H * sq * sk * D, flash_rate(dtype))
            # the device's time: bursts of launches, the kernel's and autograd
            # of SDPA's, beside the single calls
            row = rows[-1]
            with torch.no_grad():
                row['burst_ms'] = burst_ms(lambda: launch_flash_bwd(lib, 'fused', *io))
            row['library_burst_ms'] = burst_ms(lib_grad(ql, kl, vl))
            print(f'bwd: {row["kernel"]} {site} {row["dtype"]}: bursts of {LSE_BURST} '
                  f'{row["burst_ms"]:.4f} ms a launch against autograd of SDPA '
                  f'{row["library_burst_ms"]:.4f} ({row["burst_ms"] / row["library_burst_ms"]:.3f}x;'
                  f' bound {row["bound_ms"]:.4f}), single calls {row["ms"]:.4f} against '
                  f'{row["library_ms"]:.4f}', flush=True)
            with torch.no_grad():
                two = flash_bwd(*io, 'twokernel')
                record_row(rows, 'flash_bwd_dq', site, dtype, per_step(1, (TRAIN2,)), two[0],
                           ref[0], tols[0], why, lambda: launch_flash_bwd(lib, 'dq', *io),
                           lib_grad(ql), b_in + b_out_q, 6 * H * sq * sk * D,
                           flash_rate(dtype), plain_fn=lambda: flash_bwd_dq_plain(*io))
                record_row(rows, 'flash_bwd_dkv', site, dtype, per_step(1, (TRAIN2,)), two[1:],
                           ref[1:], tols[1:], why, lambda: launch_flash_bwd(lib, 'dkv', *io),
                           lib_grad(kl, vl), b_in + b_out_kv, 8 * H * sq * sk * D,
                           flash_rate(dtype), plain_fn=lambda: flash_bwd_dkv_plain(*io))
            del q, do, k, v, k_rot, ref_rot, out, lse, ref_out, ref, fused, two, ql, kl, vl, io
            del yl
            torch.cuda.empty_cache()

        # K4 and K5 in the fp32 view stage's DPT head (refinenet4/3/2, refinenet1)
        view_stage = {p: 1 for p in TRAIN_PATHS} if dtype == torch.float32 else {}
        for n_in in (16, 32, 64):
            check_resize(rows, randn(1, n_in, n_in, DPT_C, dtype=dtype), (2 * n_in, 2 * n_in),
                         view_stage)
        check_resize_s2d(rows, randn(1, TRAIN_RES // 2, TRAIN_RES // 2, DPT_C, dtype=dtype),
                         (TRAIN_RES, TRAIN_RES), view_stage)

        # K4^T: the VJP of refinenet4/3/2's upsamples and (after depth_to_space)
        # of refinenet1's K5, in the fp32 view stage
        for n_in in (16, 32, 64, 128):
            n_out = 2 * n_in
            g = randn(1, n_out, n_out, DPT_C, dtype=dtype)
            with torch.no_grad():
                out = resize_bilinear_t(g, (n_in, n_in))
                with reference_kernels():
                    ref = resize_bilinear_t(g, (n_in, n_in))
            amax = float(ref.float().abs().max())
            tol = amax * (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)
            xl = torch.zeros(1, DPT_C, n_in, n_in, dtype=dtype, device=dev,
                             requires_grad=True)
            yl = F.interpolate(xl, size=(n_out, n_out), mode='bilinear', align_corners=True)
            gl = g.permute(0, 3, 1, 2)

            def lib_t():
                return torch.autograd.grad(yl, xl, gl, retain_graph=True)

            with torch.no_grad():
                record_row(rows, 'resize_bilinear_t', f'{n_out}to{n_in}', dtype, view_stage, out,
                           ref, tol, 'the same nonzero weights in fp32, summed in another '
                           'order and rounded once: 1 bf16 ulp / 1e-6 of max|ref|',
                           lambda: resize_bilinear_t(g, (n_in, n_in)), lib_t,
                           (n_out * n_out + n_in * n_in) * DPT_C * it,
                           8 * n_out * n_out * DPT_C, PEAK_FP32)
            del g, out, ref, xl, yl
        torch.cuda.empty_cache()

    # the nerf train step: K10 with the logsumexp twice a site (the forward and
    # the remat recomputation); K11 forward at each norm, again in the
    # recomputed blocks, and backward once
    bf, f32 = torch.bfloat16, torch.float32
    for site, sq, sk, masked, dtype, n in (
            ('train_nerf_stage1_self', SK, SK, True, bf, 12),
            ('train_nerf_cross', TRAIN_ST, SK, True, f32, 6),
            ('train_nerf_ray_self', TRAIN_ST, TRAIN_ST, False, f32, 6)):
        print_plan('flash_fwd', site, 1, sq, 6, dtype, sk)
        check_flash_fwd(rows, randn, site, 1, sq, sk, masked, dtype, {TRAIN_NERF: 2 * n},
                        with_lse=True)
    for dtype in (bf, f32):
        check_flash_edges(rows, randn, tables, True, dtype)
    eps_tiny = float(np.finfo(np.float32).eps)
    for site, r, dtype, eps, n_fwd, n_bwd in (
            ('train_embed_2048', NTRI, bf, eps_tiny, 3, 3),
            ('train_stage1_2064', SK, bf, 1e-6, 96, 48),
            ('train_rays_1024', TRAIN_ST, f32, 1e-6, 74, 38),
            ('train_tris_2064', SK, f32, 1e-6, 25, 13)):
        check_rms_norm(rows, randn, site, r, dtype, eps, {TRAIN_NERF: n_fwd},
                       {TRAIN_NERF: n_bwd})
    return rows


# ---------------------------------------------------------------------------
# phase 7: the v1-base train step
# ---------------------------------------------------------------------------

def train_batch(device):
    """tools/train_step_bench.py's batch, made from numpy seed 0."""
    import torch
    rng = np.random.default_rng(0)
    b = {'triangles': rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32) * 0.3,
         'texture': rng.uniform(0, 1, (1, NTRI, 13, 32, 32)).astype(np.float32),
         'mask': np.ones((1, NTRI), bool),
         'vn': rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32),
         'c2w': np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
         'fov': np.full((1, 1, 1), 40.0, np.float32),
         'gt': rng.uniform(0, 1, (1, 1, TRAIN_RES, TRAIN_RES, 3)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


# bars of a train step against another: relative loss and grad-norm
# differences, the cosine of the flattened gradients, and the largest relative
# difference of one parameter's gradient; about 4x to 60x the kernel step's
# readings (PERF.md section 2).  The planted fault passes the first three and
# only the last catches it.
AGREE_BARS = dict(loss_rel=1e-4, grad_norm_rel=1e-3, one_minus_cosine=1e-5,
                  worst_param_rel=5e-2)


def grad_agreement(name, a, b, names):
    """The agreement measures of two (loss, grads) results, grads in the
    order of ``names``; printed, with the bars."""
    import torch
    (la, ga), (lb, gb) = a, b
    la, lb = float(la), float(lb)

    def dot(xs, ys):
        return sum(float(torch.sum(x.double() * y.double())) for x, y in zip(xs, ys))

    na, nb = dot(ga, ga) ** 0.5, dot(gb, gb) ** 0.5
    diff = torch.stack(torch._foreach_norm(torch._foreach_sub(ga, gb))).tolist()
    ref = torch.stack(torch._foreach_norm(gb)).tolist()
    rel = [(d / r if r else (0.0 if d == 0 else float('inf')), n)
           for d, r, n in zip(diff, ref, names)]
    worst = sorted(rel, reverse=True)[:3]
    m = dict(loss_rel=abs(la - lb) / abs(lb), grad_norm_rel=abs(na - nb) / nb,
             one_minus_cosine=1 - dot(ga, gb) / (na * nb), worst_param_rel=worst[0][0])
    print(f'train: {name}: loss {la:.7f} vs {lb:.7f}, grad norm {na:.6f} vs {nb:.6f}; '
          + ', '.join(f'{k} {v:.3e} (bar {AGREE_BARS[k]})' for k, v in m.items())
          + f'; worst parameters {[(n, f"{r:.3e}") for r, n in worst]}', flush=True)
    return m


def within_bars(m):
    return all(m[k] <= bar for k, bar in AGREE_BARS.items())


@contextlib.contextmanager
def planted_fault():
    """A wrong backward, the control of the agreement bars: dK keeps a factor
    log2(e) (its 1/log2(e) left out) at the unmasked sites, the view stage's
    ray self-attentions."""
    from renderformer_tpu_torch.ops import flash_attention as fa
    real = fa.flash_bwd

    def faulty(q_rot, k_rot, v, mask, lse, delta, do, variant='fused'):
        dq, dk, dv = real(q_rot, k_rot, v, mask, lse, delta, do, variant)
        return dq, (dk if mask is not None else dk * fa.LOG2E), dv

    fa.flash_bwd = faulty
    try:
        yield
    finally:
        fa.flash_bwd = real


def seeded_train_state(cfg, tc):
    """A model of ``cfg`` from the seeded init on the card, its optimizer and
    its train state."""
    import torch
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    from renderformer_tpu_torch.training import state as ts
    with torch.device('meta'):
        model = RenderFormer(cfg)
    model = model.to_empty(device='cpu')
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to('cuda')
    tx = ts.make_optimizer(tc)
    return model, tx, ts.TrainState.create(model, tx, tc)


def step_launches(path, step, state, batch):
    """One step of a train path on the main path, counts set to 0 just before
    it and read just after, against EXPECTED_LAUNCHES."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    reset_launch_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'train: {path} launches ' + json.dumps(launches), flush=True)
    if launches != EXPECTED_LAUNCHES[path]:
        fail(f'{path} launch counts {launches} != {EXPECTED_LAUNCHES[path]}')
    return state, m, launches


def check_finite(name, losses):
    print(f'train: {name} 3 steps, loss / grad norm '
          f'{[(x["loss"], x["grad_norm"]) for x in losses]}', flush=True)
    if not all(np.isfinite(x['loss']) and np.isfinite(x['grad_norm']) for x in losses):
        fail(f'train: {name} non-finite loss or grad norm')


def step_speed(card, name, step, state, batch, agree):
    """The median step of TRAIN_STEPS after a warm-up, trained rays/s, peak
    memory and the device's idle share from one profiled step; printed, with
    the agreement measures, as one 'train' JSON line."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    times = times[1:]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'train: {name} step {med * 1e3:.2f} ms median of {len(times)} '
          f'({[round(x * 1e3, 2) for x in times]} ms), {TRAIN_RES ** 2 / med:.1f} trained '
          f'rays/s, peak memory {peak:.2f} GiB, on {card}', flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print_profile(name, kernels)
    # where the host's time goes: ops by self CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:15]:
        print(f'profile: {name} host {e.self_cpu_time_total / 1e3:9.3f} ms '
              f'{e.count:5d}x {e.key[:100]}', flush=True)
    print(f'train: {name} device time {dev_ms:.2f} ms a step (profiled), device idle share '
          f'{1 - dev_ms / (med * 1e3):.3f} of the {med * 1e3:.2f} ms median step '
          f'({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.2f} ms profiled step)',
          flush=True)
    print('train ' + json.dumps({'path': name, 'step_ms': med * 1e3,
                                 'rays_per_s': TRAIN_RES ** 2 / med, 'peak_gib': peak,
                                 'device_ms': dev_ms, 'idle_share': 1 - dev_ms / (med * 1e3),
                                 **agree}), flush=True)


def train_checks(card):
    """Phase 7 for v1-base; returns the launch counts of one step of each
    backward."""
    import torch
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.training import state as ts

    t0 = time.time()
    batch = train_batch('cuda')
    tcs = {v: ts.TrainConfig(precision='bfloat16', resolution=TRAIN_RES, steps_per_epoch=100,
                             remat=True, flash_bwd=v) for v in ('fused', 'twokernel')}
    model, tx, state = seeded_train_state(PRESETS[BASE], tcs['fused'])
    n_params = sum(p.numel() for p in model.parameters())
    print(f'train: v1-base seeded init, {n_params} parameters; dtypes '
          f'{ts.resolve_dtypes(tcs["fused"])}, remat, {TRAIN_RES}^2, 1 view, {NTRI} tris '
          f'({time.time() - t0:.1f} s)', flush=True)

    # the gradient of the kernel step against the plain-version step, and a
    # planted fault that the same bars must catch
    names = [n for n, _ in model.named_parameters()]
    grads_fused = ts.make_loss_fns(model, tcs['fused'])[1]
    with reference_kernels():
        plain = grads_fused(state, batch)
    fused = grads_fused(state, batch)
    two = ts.make_loss_fns(model, tcs['twokernel'])[1](state, batch)
    with planted_fault():
        bad = grads_fused(state, batch)
    agree = {'fused_vs_plain': grad_agreement('fused vs plain', fused, plain, names),
             'twokernel_vs_plain': grad_agreement('two-kernel vs plain', two, plain, names),
             'fused_vs_twokernel': grad_agreement('fused vs two-kernel', fused, two, names)}
    control = grad_agreement('planted fault vs plain', bad, plain, names)
    for k, m in agree.items():
        if not within_bars(m):
            fail(f'train {k}: {m} past the bars {AGREE_BARS}')
    if within_bars(control):
        fail(f'train: the planted fault passes the bars ({control})')
    agree['planted_fault_vs_plain'] = control
    del plain, fused, two, bad
    torch.cuda.empty_cache()

    # one step of each backward on the main path, counts set to 0 just before
    launches, losses = {}, []
    for path, v in ((TRAIN, 'fused'), (TRAIN2, 'twokernel')):
        state, m, launches[path] = step_launches(
            path, ts.make_train_step(model, tx, tcs[v])[0], state, batch)
        losses.append(m)
    step = ts.make_train_step(model, tx, tcs['fused'])[0]
    state, m = step(state, batch)
    losses.append(m)
    check_finite('v1-base', losses)
    step_speed(card, 'v1-base', step, state, batch, agree)
    del state, model, step
    torch.cuda.empty_cache()
    return launches


def train_nerf_checks(card):
    """Phase 7 for v1-base nerf with the fused RMSNorm and the fused
    backward; returns the launch counts of one step."""
    import torch
    from renderformer_tpu_torch import V1_BASE_NERF
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.training import state as ts

    batch = train_batch('cuda')
    tc = ts.TrainConfig(precision='bfloat16', resolution=TRAIN_RES, steps_per_epoch=100,
                        remat=True, flash_bwd='fused', fused_norm=True)
    model, tx, state = seeded_train_state(V1_BASE_NERF, tc)
    print(f'train: v1-base nerf seeded init, {sum(p.numel() for p in model.parameters())} '
          f'parameters, fused_norm, fused backward', flush=True)
    names = [n for n, _ in model.named_parameters()]
    grads = ts.make_loss_fns(model, tc)[1]
    with reference_kernels():
        plain = grads(state, batch)
    agree = {'nerf_vs_plain': grad_agreement('nerf kernels vs plain', grads(state, batch),
                                             plain, names)}
    if not within_bars(agree['nerf_vs_plain']):
        fail(f'train nerf: {agree["nerf_vs_plain"]} past the bars {AGREE_BARS}')
    del plain
    torch.cuda.empty_cache()

    step = ts.make_train_step(model, tx, tc)[0]
    state, m, launches = step_launches(TRAIN_NERF, step, state, batch)
    losses = [m]
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(m)
    check_finite('v1-base nerf', losses)
    step_speed(card, 'v1-base nerf', step, state, batch, agree)
    del state, model, step
    torch.cuda.empty_cache()
    return {TRAIN_NERF: launches}


def _times(weighted):
    """ms, plain_ms, bound_ms and library_ms of (row, launches) pairs: each
    row's median times its launches, summed; library_ms None where a row has
    no library call."""
    lib = [r['library_ms'] for r, _ in weighted]
    return dict(ms=sum(r['ms'] * n for r, n in weighted),
                plain_ms=sum(r['plain_ms'] * n for r, n in weighted),
                bound_ms=sum(r['bound_ms'] * n for r, n in weighted),
                library_ms=(None if any(x is None for x in lib) else
                            sum(x * n for x, (_, n) in zip(lib, weighted))))


def kernel_summary(rows, launches):
    """One entry a kernel: its launches in each path's run, and its times
    summed over the shapes and dtypes each path runs it at (a row's per_run
    launches times its median ms), totalled over the paths and per path;
    max_abs_err over every row of the kernel, fp32 and bf16."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r['kernel'] == name]
        on_path = [(r, sum(r['per_run'].values())) for r in mine if r['per_run']]
        total = _times(on_path)
        by_ops = sum(r['bound_ms'] * n for r, n in on_path if r['bound_by'] == 'operations')
        kernels.append(dict(
            name=name, **meta, launches=sum(launches[p][name] for p in ALL_PATHS),
            launches_by_path={p: launches[p][name] for p in ALL_PATHS},
            max_abs_err=max(r['max_abs_err'] for r in mine), **total,
            bound_by='operations' if by_ops * 2 > total['bound_ms'] else 'bytes',
            by_path={p: _times([(r, r['per_run'][p]) for r in mine if p in r['per_run']])
                     for p in ALL_PATHS}))
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
    sass_check(path)

    rows = kernel_checks()
    launches = {preset: render_checks(card, preset) for preset in PATHS}
    rows += train_kernel_checks()
    launches.update(train_checks(card))
    launches.update(train_nerf_checks(card))
    for name in KERNELS:
        if not any(launches[p][name] for p in ALL_PATHS):
            fail(f'{name} was launched by no path')

    print(json.dumps({'kernels': kernel_summary(rows, launches)}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
