"""The split-TF32 GEMM of the port's fp32 linears on one GPU: its time at the
fine-tune step's shapes against its bound and cuBLAS, and where the step's
fp32 products go.

    python3 tools/torch_gemm_ab.py [--burst 20] [--iters 10] [--shapes fwd_d,...]
    python3 tools/torch_gemm_ab.py --attribute [--tree DIR] [--seed N]

Timing (the default).  At each linear kind of the v1.1-swin-large fine-tune
step's view stage (512^2, 1 view: 4,096 ray tokens, 4,112 stage-1 tokens,
width 1024, FFN 4096) and for each of its products (forward y = x w^T, dX =
gy w, dW = gy^T x), a CUDA graph of ``--burst`` calls replayed between two
events, divided by the burst (device time alone), of

  * ``kernel``: the port's op (``ops/gemm_tf32x3.py``: the split of B, the
    product, and the sum of the reduction's slices where it splits);
  * ``cublas_fp32``: torch's product with TF32 off, the path the kernel
    replaces (cuBLAS's SIMT sgemm);
  * ``cublas_tf32``: torch's product with TF32 on, single-pass, a yardstick
    only: the port never calls it on this route;

beside the split-TF32 bound (2*M*N*K flops over 494.7 / 3 TFLOP/s) and the
kernel's share of it, and each one's RMS error against float64 over the RMS
of the float64 product.  The last line sums the step's products: each kind
counted as often as one step calls it (12 layers; forward twice, remat).

Attribution (``--attribute``).  Two eager steps (no CUDA graphs, so each
kernel keeps the op that launched it) of the fine-tune cell's step, as
``rfbench/drivers/train.py`` builds it, under ``torch.profiler`` with
``record_shapes``: every device kernel whose name marks an fp32 GEMM or
GEMV, with the op, its input shapes and the linear module (forward) or
autograd node (backward) above it, summed by (kernel, op, shapes, site).
``--tree DIR`` imports the port from DIR instead (a parent's ``git
archive``).  Prints the card's nvidia-smi line, then JSON lines.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOKENS, CTX, D, FFN, LAYERS = 4096, 4112, 1024, 4096, 12
# kind: (M tokens, N out, K in, calls a forward pass)
KINDS = {
    'proj_d': (TOKENS, D, D, 6),     # cross q and out, in_proj's three, Swin out_proj
    'proj_ctx': (CTX, D, D, 2),      # cross k and v over the stage-1 tokens
    'ffn_up': (TOKENS, FFN, D, 2),   # w1, w3
    'ffn_down': (TOKENS, D, FFN, 1),  # w2
}
SPLIT_TF32_FLOPS = 494.7e12 / 3
GEMM_MARKS = ('gemm', 'Kernel2', 'gemv', 'sgemm', 'xmma', 'cutlass', 'tf32x3')


def card_line():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()


def event_ms(fn, iters):
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


def graph_ms(fn, burst, iters):
    """Device milliseconds a call: a CUDA graph of ``burst`` calls replayed
    between two events, divided by the burst."""
    import torch
    side = torch.cuda.Stream()
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


def rel_rms(got, ref):
    return float((got.double() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def timing(args):
    import torch
    sys.path.insert(0, REPO)
    from renderformer_tpu_torch.ops import gemm_tf32x3 as g3

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    want = set(args.shapes.split(',')) if args.shapes else None
    total = dict(kernel=0.0, cublas_fp32=0.0, cublas_tf32=0.0, bound=0.0)
    for kind, (m, n, k, calls) in KINDS.items():
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(n, k, device=dev, generator=gen) / k ** 0.5
        gy = torch.randn(m, n, device=dev, generator=gen)
        products = {
            # name: (kernel, torch's product, (a, b) of a b^T for float64, per step)
            'fwd': (lambda: g3.gemm_tf32x3_fwd(x, w), lambda: x @ w.t(), (x, w), 2 * calls),
            'dgrad': (lambda: g3.gemm_tf32x3_dgrad(gy, w), lambda: gy @ w, (gy, w.t()), calls),
            'wgrad': (lambda: g3.gemm_tf32x3_wgrad(gy, x), lambda: gy.t() @ x, (gy.t(), x.t()),
                      calls),
        }
        for prod, (kern, lib, (a, b), per_step) in products.items():
            name = f'{kind}.{prod}'
            if want and name not in want and kind not in want:
                continue
            mo, no = a.shape[0], b.shape[0]
            kr = a.shape[1]
            ref = a.double() @ b.double().t()
            row = dict(site=name, M=mo, N=no, K=kr, per_step=per_step,
                       plan=g3.plan(mo, no, kr, torch.cuda.get_device_properties(0)
                                    .multi_processor_count))
            bound = 2.0 * mo * no * kr / SPLIT_TF32_FLOPS * 1e3
            got = kern()
            row['kernel_err'] = rel_rms(got, ref)
            row['kernel_ms'] = graph_ms(kern, args.burst, args.iters)
            row['cublas_fp32_err'] = rel_rms(lib(), ref)
            row['cublas_fp32_ms'] = graph_ms(lib, args.burst, args.iters)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                row['cublas_tf32_err'] = rel_rms(lib(), ref)
                row['cublas_tf32_ms'] = graph_ms(lib, args.burst, args.iters)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row['bound_ms'] = bound
            row['share_of_bound'] = bound / row['kernel_ms']
            print(json.dumps({k_: (round(v, 9) if isinstance(v, float) else v)
                              for k_, v in row.items()}), flush=True)
            for key in ('kernel', 'cublas_fp32', 'cublas_tf32'):
                total[key] += row[f'{key}_ms'] * per_step * LAYERS
            total['bound'] += bound * per_step * LAYERS
            del ref, got
    total['share_of_bound'] = total['bound'] / total['kernel'] if total['kernel'] else None
    print(json.dumps(dict(site='a step (12 layers)', **{k_: round(v, 4) if v else v
                                                         for k_, v in total.items()})))


def attribute(args):
    import torch
    sys.path.insert(0, args.tree or REPO)
    sys.path.insert(1, REPO)  # rfbench from this tree
    from torch.profiler import ProfilerActivity, profile, record_function

    from rfbench import registry, scenes
    from rfbench.weights import make_weights
    from renderformer_tpu_torch.config import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.training.state import (
        TrainConfig, TrainState, make_optimizer, make_train_step)
    import renderformer_tpu_torch
    print(json.dumps(dict(port=os.path.dirname(renderformer_tpu_torch.__file__))), flush=True)

    cell = registry.load('v1.1-swin-large.train')
    mix, dev = cell.mix, torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = mix['tf32']
    torch.backends.cudnn.allow_tf32 = mix['tf32']
    with torch.device('meta'):
        model = RenderFormer(RenderFormerConfig.from_dict(cell.model))
    model.load_state_dict(make_weights(cell.model, args.seed, dev), strict=True, assign=True)
    tc = TrainConfig(learning_rate=mix['learning_rate'], weight_decay=mix['weight_decay'],
                     max_grad_norm=mix['max_grad_norm'], num_epochs=1,
                     steps_per_epoch=mix['schedule_steps'], warmup_steps=0,
                     resolution=mix['resolution'], precision=mix['precision'],
                     view_precision=mix['view_precision'], remat=mix['remat'],
                     cuda_graphs=False)
    tx = make_optimizer(tc)
    state = TrainState.create(model, tx, tc)
    step, _ = make_train_step(model, tx, tc)
    pool = scenes.train_pool(args.seed, mix)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pool[-1].items() if k != 'real'}

    labels = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            labels[mod] = name

    def pre(mod, _args):
        mod._rf_attr = record_function(f'linear {labels[mod]} {tuple(mod.weight.shape)}')
        mod._rf_attr.__enter__()

    def post(mod, _args, _out):
        mod._rf_attr.__exit__(None, None, None)

    hooks = [m.register_forward_pre_hook(pre) for m in labels]
    hooks += [m.register_forward_hook(post) for m in labels]
    for _ in range(2):  # warm-up
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()

    def site(evt):
        """(the linear label or autograd node above evt, the innermost aten op)."""
        op, where, e = None, None, evt
        while e is not None:
            if op is None and e.name.startswith('aten::'):
                op = (e.name, [list(s) for s in e.input_shapes if s])
            if e.name.startswith('linear ') and where is None:
                where = e.name
            if e.name.startswith('autograd::engine::evaluate_function') and where is None:
                where = e.name.split(': ', 1)[-1]
            e = e.cpu_parent
        return op, where or 'no linear or autograd node (python)'

    rows = {}
    for evt in prof.events():
        kernels = getattr(evt, 'kernels', None) or []
        for kern in kernels:
            if not any(m in kern.name for m in GEMM_MARKS):
                continue
            op, where = site(evt)
            key = (kern.name[:90], json.dumps(op), where)
            r = rows.setdefault(key, [0, 0.0])
            r[0] += 1
            r[1] += kern.duration / 1e6
    total = sum(r[1] for r in rows.values())
    for (kern, op, where), (n, s) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(json.dumps(dict(kernel=kern, op=json.loads(op), site=where, launches=n,
                              s_over_2_steps=round(s, 6))))
    print(json.dumps(dict(total_s_over_2_steps=round(total, 6))))
    by_kernel = {}
    for (kern, _, _), (n, s) in rows.items():
        k = by_kernel.setdefault(kern, [0, 0.0])
        k[0] += n
        k[1] += s
    for kern, (n, s) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1]):
        print(json.dumps(dict(kernel=kern, launches=n, s_over_2_steps=round(s, 6))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--burst', type=int, default=20)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--shapes', default='', help='comma-separated sites or kinds')
    ap.add_argument('--attribute', action='store_true')
    ap.add_argument('--tree', default='')
    ap.add_argument('--seed', type=int, default=2147000201)
    args = ap.parse_args()
    print(card_line(), flush=True)
    if args.attribute:
        attribute(args)
    else:
        timing(args)


if __name__ == '__main__':
    main()
