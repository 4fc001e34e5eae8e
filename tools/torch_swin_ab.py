"""A/B of the Swin window attention kernels (K6, K6^T) between source trees on one GPU.

    python3 tools/torch_swin_ab.py --trees PARENT NEW [MORE ...] [--steps 5] [--no-step]

Each tree is a checkout of the repository (for example a ``git archive`` of
another commit unpacked into an ignored directory, or a copy of the working
tree with a kernel edited: a variant).  Each tree's ``csrc/`` builds by its
own ``_build.py`` into a library of its own, loaded by ctypes beside the
others, and the C entry points ``rf_swin_window_attention`` and
``rf_swin_window_attention_bwd`` are called directly on the same tensors:

  * K6 and K6^T in fp32 at every shape that runs them in fp32 (8 heads of
    128, unshifted and shifted by 4): the swin-large train step's 64
    windows, the 128^2 fp32 render's 8 views x 4 windows and phase 3's 8
    views x 64 windows; device milliseconds a call by CUDA graphs of 20
    calls, the trees in turns (T1 .. Tn, Tn .. T1), beside SDPA and autograd
    of SDPA with the boolean window mask timed the same way, and each
    tree's error against the plain versions over the bar of 2^-16 of
    max|ref| (K6^T: two launches the same bits too);
  * the bf16 instantiations at the 8-view render's 512 windows, K6 and
    K6^T: every tree's outputs bit for bit with the first tree's;
  * unless --no-step, the swin-large train step of ``chip_smoke.py``
    phase 7 (512^2, 1 view, bf16 stage 1, fp32 view stage, remat, fused
    backward) in one process a tree, turns T1, T2, T2, T1: the median wall
    ms of --steps steps after a warm-up, and the device ms of one profiled
    step with its K6 and K6^T rows.

Prints the card's nvidia-smi line, then one JSON line a measurement.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

H, D = 8, 128
BURST = 20
# site, windows, dtype name, patch grid side: the train step's 64 windows of
# the 64 x 64 grid, the fp32 render's 8 views of a 16 x 16 grid at 128^2,
# and 8 views of the 64 x 64 grid (phase 3's fp32 rows; bf16: the render)
SITES = (('train', 64, 'float32', 64), ('render128_fp32', 32, 'float32', 16),
         ('8views_fp32', 512, 'float32', 64), ('8views', 512, 'bfloat16', 64))


def tree_library(tree, index):
    """The kernel library of ``tree``, built by the tree's own _build.py."""
    path = os.path.join(os.path.abspath(tree), 'renderformer_tpu_torch', '_build.py')
    spec = importlib.util.spec_from_file_location(f'_ab_build_{index}', path)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = ctypes.CDLL(build.build())
    for name in ('rf_swin_window_attention', 'rf_swin_window_attention_bwd'):
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def swin_calls(lib, q, k, v, do, regions):
    """(forward, backward) of one library on these tensors, each a function
    that launches the kernel and returns its outputs (fresh tensors)."""
    import torch
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops.swin_attention import q_scale
    bw, _, c = q.shape
    dtype = _build.DTYPE_CODES[str(q.dtype).split('.')[-1]]
    reg = regions.data_ptr() if regions is not None else None
    nw = regions.shape[0] if regions is not None else 1
    qs = q_scale(D)

    def fwd():
        out = torch.empty_like(q)
        _build.check(lib.rf_swin_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), reg, out.data_ptr(), dtype,
            int(regions is not None), bw, nw, c // D, qs,
            torch.cuda.current_stream().cuda_stream), 'rf_swin_window_attention')
        return out

    def bwd():
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        _build.check(lib.rf_swin_window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), reg, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dtype, int(regions is not None), bw, nw, c // D, qs,
            torch.cuda.current_stream().cuda_stream), 'rf_swin_window_attention_bwd')
        return dq, dk, dv

    return fwd, bwd


def over_bar(got, ref):
    """max |got - ref| over 2^-16 of max|ref|, the fp32 bar."""
    return float((got - ref).abs().max()) / (2.0 ** -16 * float(ref.abs().max()))


def kernel_ab(trees, libs):
    import torch
    import torch.nn.functional as F
    from chip_smoke import autograd_graph_ms, graph_burst_ms
    from renderformer_tpu_torch.nn.swin import swin_attn_mask
    from renderformer_tpu_torch.ops.swin_attention import (
        region_table, swin_window_attention_bwd_plain, swin_window_attention_plain)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    turns = list(range(len(trees))) + list(reversed(range(len(trees))))
    for name, bw, dtype, grid in SITES:
        dtype = getattr(torch, dtype)
        nw = (grid // 8) ** 2
        for shift in (0, 4):
            q, k, v, do = (torch.randn(bw, 64, H * D, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            regions = region_table(grid, grid, 8, shift, dev) if shift else None
            calls = [swin_calls(lib, q, k, v, do, regions) for lib in libs]
            site = f'{name}_{"shifted" if shift else "unshifted"}'
            with torch.no_grad():
                outs = [(f(), b(), b()) for f, b in calls]
                torch.cuda.synchronize()
            row = dict(site=site, dtype=str(dtype).split('.')[-1], bw=bw, trees=trees)
            if dtype == torch.bfloat16:
                row['fwd_same_bits_as_first'] = [torch.equal(o[0], outs[0][0]) for o in outs]
                row['bwd_same_bits_as_first'] = [all(torch.equal(a, b) for a, b in
                                                     zip(o[1], outs[0][1])) for o in outs]
                print('swin_ab ' + json.dumps(row), flush=True)
                continue
            ref = swin_window_attention_plain(q, k, v, H, regions)
            refs = swin_window_attention_bwd_plain(q, k, v, do, H, regions)
            row['fwd_over_bar'] = [over_bar(o[0], ref) for o in outs]
            row['bwd_over_bar'] = [[over_bar(a, b) for a, b in zip(o[1], refs)] for o in outs]
            row['bwd_same_bits_twice'] = [all(torch.equal(a, b) for a, b in zip(o[1], o[2]))
                                          for o in outs]
            fwd_ms = {i: [] for i in range(len(trees))}
            bwd_ms = {i: [] for i in range(len(trees))}
            with torch.no_grad():
                for i in turns:
                    fwd_ms[i].append(graph_burst_ms(calls[i][0], BURST))
                    bwd_ms[i].append(graph_burst_ms(calls[i][1], BURST))
            am = None
            if shift:
                am = torch.from_numpy(swin_attn_mask(grid, grid, 8, shift)).to(dev)
                am = am.repeat(bw // nw, 1, 1)[:, None]
            qh, kh, vh, gh = (t.reshape(bw, 64, H, D).transpose(1, 2).contiguous()
                              for t in (q, k, v, do))
            with torch.no_grad():
                row['sdpa_graph_ms'] = graph_burst_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am), BURST)
            row['sdpa_grad_graph_ms'] = autograd_graph_ms(
                lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=am),
                (qh, kh, vh), gh, BURST)
            row['fwd_graph_ms'] = [fwd_ms[i] for i in range(len(trees))]
            row['bwd_graph_ms'] = [bwd_ms[i] for i in range(len(trees))]
            print('swin_ab ' + json.dumps(row), flush=True)
            del q, k, v, do, outs, calls, qh, kh, vh, gh
            torch.cuda.empty_cache()


def step_worker(tree, steps):
    """The swin-large train step from ``tree``'s own package and chip_smoke."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import renderformer_tpu_torch
    from chip_smoke import SWIN, SWIN_TRAIN_RES, seeded_train_state, train_batch
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.training import state as ts
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = train_batch('cuda', SWIN_TRAIN_RES)
    tc = ts.TrainConfig(precision='bfloat16', resolution=SWIN_TRAIN_RES, steps_per_epoch=100,
                        remat=True, flash_bwd='fused')
    model, tx, state = seeded_train_state(PRESETS[SWIN], tc)
    step = ts.make_train_step(model, tx, tc)[0]
    times = []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def rows_ms(*names):
        mine = [e for e in rows if any(n in e.key for n in names)]
        return (round(sum(e.self_device_time_total for e in mine) / 1e3, 4),
                sum(e.count for e in mine))

    fwd_ms, fwd_n = rows_ms('swin_kernel', 'swin_fwd_f32_kernel')
    bwd_ms, bwd_n = rows_ms('swin_bwd_kernel', 'swin_bwd_f32_kernel')
    print(json.dumps(dict(
        tree=tree, package=os.path.dirname(renderformer_tpu_torch.__file__),
        step_ms=round(statistics.median(times[1:]) * 1e3, 2),
        device_ms=round(sum(e.self_device_time_total for e in rows) / 1e3, 3),
        swin_fwd_ms=fwd_ms, swin_fwd_launches=fwd_n, swin_bwd_ms=bwd_ms,
        swin_bwd_launches=bwd_n, device_ops=sum(e.count for e in rows))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs='+', metavar='TREE')
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--no-step', action='store_true', help='time the kernels only')
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return step_worker(args.worker, args.steps)
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this A/B needs one GPU')
    if not args.trees or len(args.trees) < 2:
        sys.exit('--trees takes two trees or more')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = [tree_library(tree, i) for i, tree in enumerate(args.trees)]
    kernel_ab(args.trees, libs)
    if args.no_step:
        return
    old, new = args.trees[:2]
    for tree in (old, new, new, old):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), '--worker', tree,
                              '--steps', str(args.steps)], capture_output=True, text=True)
        lines = [l for l in res.stdout.splitlines() if l.startswith('{')]
        if res.returncode or not lines:
            sys.exit(f'{tree}: rc {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}')
        print('swin_step ' + lines[-1], flush=True)


if __name__ == '__main__':
    main()
