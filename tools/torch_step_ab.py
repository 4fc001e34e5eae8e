"""A/B timing of the port's train steps between two source trees on one GPU.

    python3 tools/torch_step_ab.py --trees OLD NEW [--steps 5]

Each tree is a checkout of the repository (for example a ``git archive`` of
another commit unpacked into an ignored directory).  For each turn, in the
order OLD, NEW, NEW, OLD, one process imports ``renderformer_tpu_torch`` from
that tree (building its kernels there on first use) and runs the train steps
of ``chip_smoke.py`` phase 7 from one seeded model each: v1-base with the
fused backward (K8), and v1-base nerf with the fused RMSNorm (1 scene x 1
view x 2048 triangles at 256^2, bf16 stage 1 with an fp32 view stage,
remat, AdamW): the median wall milliseconds of ``--steps`` steps after a
warm-up, and the device milliseconds of one profiled step with the rows of
the flash backward's dK/dV kernels (K8), of the K broadcast-rotate (K3) and
of the fused RMSNorm's forward and backward kernels (K11) summed apart,
with K11's backward launches and every device operation the step ran.  The batch and the
model come from the tree's own ``chip_smoke.py`` (``train_batch``,
``seeded_train_state``).  Prints the card's nvidia-smi line, then one JSON
line a turn.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


# the flash backward's dK/dV kernels (K8): fp32 (and, before the bf16 path
# moved to wgmma, bf16) in flash_bwd.cu, bf16 in flash_bwd_sm90.cu
BWD_KERNELS = ('flash_bwd_kv_kernel', 'flash_bwd_sm90_kernel')


def worker(tree, steps):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import renderformer_tpu_torch
    from chip_smoke import TRAIN_RES, seeded_train_state, train_batch
    from renderformer_tpu_torch import V1_BASE_NERF
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.training import state as ts
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'tree': tree, 'package': os.path.dirname(renderformer_tpu_torch.__file__)}
    batch = train_batch('cuda')
    for name, cfg, fused_norm in (('v1-base', PRESETS['v1-base'], False),
                                  ('v1-base nerf', V1_BASE_NERF, True)):
        tc = ts.TrainConfig(precision='bfloat16', resolution=TRAIN_RES, steps_per_epoch=100,
                            remat=True, flash_bwd='fused', fused_norm=fused_norm)
        model, tx, state = seeded_train_state(cfg, tc)
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
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = dict(
            step_ms=round(statistics.median(times[1:]) * 1e3, 2),
            device_ms=round(sum(e.self_device_time_total for e in rows) / 1e3, 3),
            flash_bwd_ms=round(sum(e.self_device_time_total for e in rows
                                   if any(n in e.key for n in BWD_KERNELS)) / 1e3, 3),
            rot_kv_ms=round(sum(e.self_device_time_total for e in rows
                                if 'rot_kv_kernel' in e.key) / 1e3, 3),
            norm_fwd_ms=round(sum(e.self_device_time_total for e in rows
                                  if 'rms_norm_fwd_kernel' in e.key) / 1e3, 3),
            norm_bwd_ms=round(sum(e.self_device_time_total for e in rows
                                  if 'rms_norm_bwd_kernel' in e.key) / 1e3, 3),
            norm_bwd_launches=sum(e.count for e in rows if 'rms_norm_bwd_kernel' in e.key),
            device_ops=sum(e.count for e in rows))
        del model, tx, state, step
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trees', nargs=2, metavar=('OLD', 'NEW'))
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.steps)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    old, new = args.trees
    for tree in (old, new, new, old):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), '--worker', tree,
                              '--steps', str(args.steps)], capture_output=True, text=True)
        lines = [l for l in res.stdout.splitlines() if l.startswith('{')]
        if res.returncode or not lines:
            sys.exit(f'{tree}: rc {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}')
        print(lines[-1], flush=True)


if __name__ == '__main__':
    main()
