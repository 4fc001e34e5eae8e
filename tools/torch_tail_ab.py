"""A/B timing of the port's DPT output tails on one GPU, whole renders.

    python3 tools/torch_tail_ab.py [--presets v1-base v1.1-swin-large] [--renders 5]

For each preset, from one seeded model, renders the bench.py workload
(1 scene x 8 views x 2048 triangles, 512^2, bf16, inputs already on the
card) with ``RuntimeConfig(dpt_tail='plain')`` and with the default
``'composed'`` tail, in turns (plain, composed, composed, plain), and
prints the card's nvidia-smi line, then one JSON line per preset with the
median wall milliseconds of each turn, each tail's device milliseconds
from one profiled render (the sum of its kernels' device times), and the
HDR PSNR of the composed render against the plain one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

V, RES, NTRI = 8, 512, 2048


def bench_inputs():
    """bench.py's workload, made from numpy seed 0."""
    rng = np.random.default_rng(0)
    return (
        rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32) * 0.3,
        rng.uniform(0, 1, (1, NTRI, 13, 32, 32)).astype(np.float32),
        np.ones((1, NTRI), bool),
        rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32),
        np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1)),
        np.full((1, V, 1), 40.0, np.float32),
    )


def wall_ms(render, n):
    """Median wall milliseconds of n renders, after one warm-up."""
    import torch
    render()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def device_ms(render):
    """Device milliseconds of one profiled render: its kernels' sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--presets', nargs='+', default=['v1-base', 'v1.1-swin-large'])
    ap.add_argument('--renders', type=int, default=5)
    args = ap.parse_args()

    import torch
    from renderformer_tpu_torch import RenderingPipeline, RuntimeConfig

    if not torch.cuda.is_available():
        sys.exit('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    scene = tuple(torch.as_tensor(a, device='cuda') for a in bench_inputs())
    for preset in args.presets:
        base = RenderingPipeline.from_pretrained(preset, seed=0)
        pipes = {tail: RenderingPipeline(base.model, runtime=RuntimeConfig(dpt_tail=tail))
                 for tail in ('plain', 'composed')}
        renders = {tail: (lambda p=p: p.render(*scene, resolution=RES, precision='bf16'))
                   for tail, p in pipes.items()}
        turns = [(tail, wall_ms(renders[tail], args.renders))
                 for tail in ('plain', 'composed', 'composed', 'plain')]
        dev = {tail: device_ms(fn) for tail, fn in renders.items()}
        ref = renders['plain']().float().cpu().numpy()
        got = renders['composed']().float().cpu().numpy()
        mse = float(((ref - got) ** 2).mean())
        psnr = 10 * np.log10(float(ref.max() - ref.min()) ** 2 / max(mse, 1e-30))
        print(json.dumps({'preset': preset, 'renders_per_turn': args.renders,
                          'turns_ms': turns, 'device_ms': dev,
                          'psnr_composed_vs_plain_db': psnr}), flush=True)
        del base, pipes, renders
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
