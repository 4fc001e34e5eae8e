"""A/B timing of the port's bf16 render between two source trees on one GPU.

    python3 tools/torch_render_ab.py --trees OLD NEW [--presets v1-base v1.1-swin-large
                                     'v1-base nerf'] [--renders 5]

Each tree is a checkout of the repository (for example a ``git archive`` of
another commit unpacked into an ignored directory).  For each turn, in the
order OLD, NEW, NEW, OLD, one process imports ``renderformer_tpu_torch`` from
that tree (building its kernels there on first use) and, for each preset,
renders the bench.py workload (1 scene x 8 views x 2048 triangles, 512^2,
bf16, inputs already on the card) from one seeded model, built as the
tree's own ``chip_smoke.py`` builds it (``render_pipeline``: 'v1-base nerf'
is V1_BASE_NERF with the fused RMSNorm): the median wall
milliseconds of ``--renders`` renders after a warm-up, and the device
milliseconds of one profiled render.  Prints the card's nvidia-smi line,
then one JSON line a turn.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(tree, presets, renders):
    sys.path.insert(0, HERE)
    from torch_tail_ab import RES, bench_inputs, device_ms, wall_ms
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import renderformer_tpu_torch
    from chip_smoke import render_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'tree': tree, 'package': os.path.dirname(renderformer_tpu_torch.__file__)}
    scene = tuple(torch.as_tensor(a, device='cuda') for a in bench_inputs())
    for preset in presets:
        pipe = render_pipeline(preset)

        def render():
            return pipe.render(*scene, resolution=RES, precision='bf16')

        out[preset] = {'wall_ms': wall_ms(render, renders), 'device_ms': device_ms(render)}
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trees', nargs=2, required=True, metavar=('OLD', 'NEW'))
    ap.add_argument('--presets', nargs='+', default=['v1-base', 'v1.1-swin-large'])
    ap.add_argument('--renders', type=int, default=5)
    ap.add_argument('--worker', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.presets, args.renders)

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    old, new = args.trees
    for tree in (old, new, new, old):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--trees', old, new, '--worker', tree,
             '--presets', *args.presets, '--renders', str(args.renders)],
            capture_output=True, text=True)
        if res.returncode:
            sys.exit(f'turn on {tree} failed:\n{res.stderr[-4000:]}')
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == '__main__':
    main()
