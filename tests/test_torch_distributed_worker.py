"""One rank of a two-process gloo group of the port, for
tests/test_torch_ring_attention.py and tests/test_torch_distributed.py.

    python tests/test_torch_distributed_worker.py MODE RANK WORLD INIT_FILE IN_NPZ OUT_DIR

MODE ``ring``: ``ring_attention`` of every case in IN_NPZ on a (1, 2) mesh
(the ring over the two ranks) and a (2, 1) mesh (the batch split over
them), forward and the gradients of sum((out - tgt)^2), written to
``OUT_DIR/ring_rank<RANK>.npz``.  MODE ``model``: the tiny model's render
unsharded, on a (2, 1) mesh and on a (1, 2) mesh, of scenes of 8 triangles
(12 tokens with the registers: every full attention site takes the ring)
and of 7 (11 tokens: the triangle sites attend whole, the view-stage cross
site splits its queries, the ray self site takes the ring), with the
calls of each strategy, then one epoch of the trainer on an in-memory
dataset, written to ``OUT_DIR/model_rank<RANK>.npz`` with the ranks'
checkpoint writes.
Imports torch and the port only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from renderformer_tpu_torch.parallel.distributed import (  # noqa: E402
    setup_distributed, teardown_distributed)
from renderformer_tpu_torch.parallel.sharding import make_mesh  # noqa: E402

TINY = dict(latent_dim=72, num_layers=2, num_heads=2, dim_feedforward=144,
            num_register_tokens=4, vertex_pe_num_freqs=4,
            view_transformer_latent_dim=72, view_transformer_ffn_hidden_dim=144,
            view_transformer_n_heads=2, view_transformer_n_layers=4,
            dpt_features=16, dpt_out_channels=[8, 16, 32, 64])
RES = 32


def ring(inputs, out):
    from renderformer_tpu_torch.parallel.ring_attention import ring_attention
    cases = sorted({k.split('/')[0] for k in inputs})
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape)
        for case in cases:
            q, k, v, tgt = (torch.from_numpy(inputs[f'{case}/{n}']).requires_grad_(n != 'tgt')
                            for n in ('q', 'k', 'v', 'tgt'))
            mask = (torch.from_numpy(inputs[f'{case}/mask'])
                    if f'{case}/mask' in inputs else None)
            for impl in ('xla', 'flash'):
                o = ring_attention(q, k, v, mask, mesh=mesh, impl=impl)
                grads = torch.autograd.grad(((o - tgt) ** 2).sum(), (q, k, v))
                tag = f'{shape[0]}x{shape[1]}/{case}/{impl}'
                for name, t in zip(('out', 'dq', 'dk', 'dv'), (o, *grads)):
                    out[f'{tag}/{name}'] = t.detach().numpy()


def scene_batch(rng, b, n, v):
    return {'triangles': rng.normal(size=(b, n, 3, 3)).astype(np.float32) * 0.3,
            'texture': rng.uniform(0, 1, (b, n, 13, 32, 32)).astype(np.float32),
            'mask': np.ones((b, n), bool), 'vn': rng.normal(size=(b, n, 3, 3)).astype(np.float32),
            'c2w': np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1)),
            'fov': np.full((b, v, 1), 40.0, np.float32)}


def memory_dataset(root, n_scenes=8, n_tris=8, seed=0):
    """The port's dataset on scenes held in memory (the H5 read replaced),
    ground truth as PNGs in ``root``."""
    from renderformer_tpu_torch.io.h5 import pad_scene
    from renderformer_tpu_torch.io.image import write_png
    from renderformer_tpu_torch.training.dataset import RenderFormerDataset
    rng = np.random.default_rng(seed)
    scenes = {}
    for i in range(n_scenes):
        c2w = np.eye(4, dtype=np.float32)[None].copy()
        c2w[0, 2, 3] = 2.0
        path = os.path.join(root, f'scene_{i:03d}.h5')
        scenes[path] = {
            'triangles': rng.normal(size=(n_tris, 3, 3)).astype(np.float32) * 0.3,
            'texture': rng.uniform(0, 1, (n_tris, 13, 32, 32)).astype(np.float32),
            'vn': rng.normal(size=(n_tris, 3, 3)).astype(np.float32),
            'c2w': c2w, 'fov': np.full((1,), 40.0, np.float32)}
        gt = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
        if not os.path.exists(path[:-3] + '.png'):  # the test writes them before the ranks
            write_png(path[:-3] + '.png', gt)

    class MemoryDataset(RenderFormerDataset):
        def _list_scenes(self, h5_dir):
            return sorted(scenes)

        def _scene_shape(self, path):
            return scenes[path]['triangles'].shape[0], scenes[path]['texture'].shape[-1]

        def _read_scene(self, path):
            return pad_scene(scenes[path], self.padding_length)

    return MemoryDataset(root, root, max_resolution=RES)


def init_model():
    """The tiny model from seed 0."""
    from renderformer_tpu_torch import RenderFormerConfig
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    return init_weights(RenderFormer(RenderFormerConfig(**TINY)),
                        torch.Generator().manual_seed(0))


def fit(root, ckpt):
    """One epoch of the tiny model, global batch 2; returns the trainer."""
    from renderformer_tpu_torch.training.state import TrainConfig
    from renderformer_tpu_torch.training.trainer import RenderFormerTrainer, TrainerConfig
    tc = TrainConfig(precision='float32', view_precision='float32', num_epochs=1)
    cfg = TrainerConfig(train=tc, batch_size=2, checkpoint_dir=ckpt, save_interval=1,
                        log_dir=os.path.join(ckpt, 'runs'), seed=3)
    tr = RenderFormerTrainer(init_model(), cfg, device='cpu', dataset=memory_dataset(root))
    tr.fit()
    return tr


def model(rank, out, root):
    from renderformer_tpu_torch import RenderFormerConfig, RenderingPipeline
    from renderformer_tpu_torch.nn import attention
    from renderformer_tpu_torch.training import trainer as trainer_mod
    calls = {'ring': 0, 'split': 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    attention.ring_attention = counted('ring', attention.ring_attention)
    attention.seq_split_attention = counted('split', attention.seq_split_attention)
    kw = dict(resolution=RES, precision='fp32')
    for n_tris, cases in ((8, (('data2', (2, 1)), ('ring2', (1, 2)))),
                          (7, (('split2', (1, 2)),))):
        pipe = RenderingPipeline.from_config(RenderFormerConfig(**TINY), seed=0, device='cpu')
        args = scene_batch(np.random.default_rng(0), 2, n_tris, 2)
        out[f'unsharded/{n_tris}'] = pipe.render(**args, **kw).numpy()
        for name, shape in cases:
            pipe.use_mesh(shape)
            calls.update(ring=0, split=0)
            out[name] = pipe.render(**args, **kw).numpy()
            out[f'calls/{name}'] = np.array([calls['ring'], calls['split']])

    writes = []
    real = trainer_mod.write_checkpoint

    def counted(ckpt_dir, tag, *a, **k):
        writes.append(tag)
        return real(ckpt_dir, tag, *a, **k)

    trainer_mod.write_checkpoint = counted
    tr = fit(root, os.path.join(root, 'ckpt'))
    out['fit/loss'] = np.array([m['loss'] for m in tr.step_metrics])
    out['fit/grad_norm'] = np.array([m['grad_norm'] for m in tr.step_metrics])
    out['fit/val'] = np.array(tr.val_losses)
    for n, p in tr.model.named_parameters():
        out[f'param/{n}'] = p.detach().numpy()
    with open(os.path.join(root, f'writes_rank{rank}.json'), 'w') as f:
        json.dump({'writes': writes, 'mesh': list(tr.mesh.shape)}, f)


def run_group(mode, out_dir, in_npz='', world=2, timeout=300):
    """The worker's ``mode`` on ``world`` ranks of a gloo group that meets
    in a FileStore under ``out_dir``; returns each rank's results."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    init = os.path.join(out_dir, f'{mode}_init')
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               mode, str(r), str(world), init, in_npz, out_dir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors='replace'))
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(out_dir, f'{mode}_rank{r}.npz'))) for r in range(world)], logs


def main():
    mode, rank, world, init_file, in_npz, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert setup_distributed(f'file://{init_file}', world, rank, device='cpu')
    out = {}
    try:
        if mode == 'ring':
            ring(dict(np.load(in_npz)), out)
        else:
            model(rank, out, out_dir)
    finally:
        teardown_distributed()
    np.savez(os.path.join(out_dir, f'{mode}_rank{rank}.npz'), **out)


if __name__ == '__main__':
    main()
