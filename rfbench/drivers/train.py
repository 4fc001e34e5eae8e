"""The fine-tuning job: ``training.state.make_train_step``'s step, batch after batch.

Set-up builds the one train state (the model's float32 masters and AdamW's
moments) and the step, then drives them through the job's first steps,
which are compared with the reference afterwards; the window goes on with
the same state and step.  Each step's batch goes from pinned host memory
to the device with ``non_blocking``, as the trainer uploads it.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List

import torch

from rfbench import counts, scenes
from rfbench.reference import train as reference
from rfbench.weights import make_weights

B1 = 0.9            # AdamW's first-moment decay: mu after one step is (1 - B1) * g
# leaves whose reference gradient is nought to rounding, under float32's
# epsilon times the median leaf's, are left out of change_gap
EXCLUDED = float(torch.finfo(torch.float32).eps)


def gap(got: float, ref: float, scale: float) -> float:
    return abs(got - ref) / max(abs(ref), scale, 1e-30)


def rms_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The RMS of got - ref over the RMS of ref, float64 sums."""
    ref = ref.double()
    return float((got.double() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keep=None):
    """(the widest gap of a leaf's norm, against the reference's norm of
    that leaf or of the median leaf, whichever is larger; that leaf)."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in names)
    return max((gap(got[n], ref[n], median), n) for n in names)


class Driver:
    def __init__(self, cell, seed: int, device: str = 'cuda'):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.model, cell.mix
        self.records: List[Dict] = []
        self.next = 0
        self.launches: Dict[tuple, int] = {}
        self.attempted = self.failed = 0
        self.phases: List = []

    # ------------------------------------------------------------------ set-up
    def train_config(self):
        from renderformer_tpu_torch.training.state import TrainConfig
        m = self.mix
        return TrainConfig(learning_rate=m['learning_rate'], weight_decay=m['weight_decay'],
                           max_grad_norm=m['max_grad_norm'], num_epochs=1,
                           steps_per_epoch=m['schedule_steps'], warmup_steps=0,
                           resolution=m['resolution'], precision=m['precision'],
                           view_precision=m['view_precision'], remat=m['remat'])

    def setup(self):
        from renderformer_tpu_torch.config import RenderFormerConfig
        from renderformer_tpu_torch.models.renderformer import RenderFormer
        from renderformer_tpu_torch.training.state import (
            TrainState, make_optimizer, make_train_step)
        # the stages in float32 compute so: TF32 off for cuBLAS and cuDNN
        # (torch leaves it on for cuDNN's convolutions)
        torch.backends.cuda.matmul.allow_tf32 = self.mix['tf32']
        torch.backends.cudnn.allow_tf32 = self.mix['tf32']
        weights = make_weights(self.cfg, self.seed, self.device)
        with torch.device('meta'):
            model = RenderFormer(RenderFormerConfig.from_dict(self.cfg))
        model.load_state_dict(weights, strict=True, assign=True)
        del weights
        tc = self.train_config()
        tx = make_optimizer(tc)
        self.state = TrainState.create(model, tx, tc)
        self.train_step, _ = make_train_step(model, tx, tc)
        self.mark('model')
        pin = self.device.type == 'cuda'
        host = scenes.train_pool(self.seed, self.mix)
        self.real = [b.pop('real') for b in host]
        self.pool = [{k: (torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v))
                      for k, v in b.items()} for b in host]
        self.order = scenes.order(self.seed, len(self.pool), self.mix['max_steps'])
        self.mark('batches')
        # the job's first steps, through the window's own call and feed
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        start = [p.detach().clone() for p in params]
        self.checked = dict(losses=[], norms=[], rows=[])
        for s in range(self.mix['checked_steps']):
            self.checked['rows'].append(int(self.order[self.next]))
            with self.stage_one_tokens() if s == 0 else contextlib.nullcontext():
                rec = self.step(count=s == self.mix['checked_steps'] - 1)
            self.checked['losses'].append(rec['loss'])
            self.checked['norms'].append(rec['grad_norm'])
            if s == 0:
                mu = self.state.opt_state['mu']
                norms = torch.stack(torch._foreach_norm([mu[n] for n in names])).tolist()
                self.checked['grad'] = {n: v / (1 - B1) for n, v in zip(names, norms)}
                # the view stage's gradients before the clip: the step's own clip undone
                clip = self.mix['max_grad_norm']
                scale = 1.0 if rec['grad_norm'] < clip else clip / rec['grad_norm']
                self.checked['view_grad'] = {n: v / scale for n, v in
                                             self.checked['grad'].items()
                                             if n.startswith(reference.VIEW_PREFIX)}
            self.mark(f'step {s}')
        diffs = torch._foreach_sub([p.detach() for p in params], start)
        self.checked['change'] = dict(zip(names, torch.stack(torch._foreach_norm(diffs)).tolist()))
        del start, diffs
        self.mark('change')

    @contextlib.contextmanager
    def stage_one_tokens(self):
        """Keeps, from the step run inside, the stage-1 tokens that the
        program's view stage takes (its first call's ``tri_tokens``), as
        ``self.ctx``: the one piece of the program's state the reference
        reads, to hold the view stage alone (``view_grad_gap``)."""
        self.ctx = None

        def keep(mod, args):
            if self.ctx is None:
                self.ctx = args[2].detach().float().clone()

        models = [m for m in (self.state.model, self.state.shadow) if m is not None]
        hooks = [m.view_transformer.register_forward_pre_hook(keep) for m in models]
        try:
            yield
        finally:
            for h in hooks:
                h.remove()

    def mark(self, phase: str) -> None:
        self.sync()
        self.phases.append((phase, time.perf_counter()))

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ traffic
    def step(self, count: bool = False) -> Dict:
        from renderformer_tpu_torch import ops
        i = self.next
        self.next += 1
        row = int(self.order[i % len(self.order)])
        self.attempted += 1
        before = dict(ops.LAUNCHES) if count else None
        t = time.perf_counter()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in self.pool[row].items()}
        self.state, met = self.train_step(self.state, batch)
        done = time.perf_counter()
        if count:
            key = (self.real[row],) + tuple(sorted(
                (k, v - before[k]) for k, v in ops.LAUNCHES.items() if v != before[k]))
            self.launches[key] = self.launches.get(key, 0) + 1
        ok = all(map(lambda x: x == x and abs(x) != float('inf'), met.values()))
        self.failed += not ok
        return dict(i=i, n=self.real[row], t_start=t, t_done=done, ok=ok, loss=met['loss'],
                    grad_norm=met['grad_norm'],
                    rays=self.mix['views'] * self.mix['resolution'] ** 2,
                    flops=counts.train_flops(self.cfg, self.real[row], self.mix['views'],
                                             self.mix['resolution']))

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.records = []
        while time.perf_counter() < deadline:
            self.records.append(self.step(count=len(self.records) < 2))
        return dict(t0=t0, t_end=self.records[-1]['t_done'], records=self.records)

    def tail(self, steps: int = 2) -> Dict:
        recs = [self.step() for _ in range(steps)]
        return dict(records=recs, sites=[counts.train_sites(
            self.cfg, r['n'], self.mix['views'], self.mix['resolution'],
            dtype=self.mix['precision'], view_dtype=self.view_dtype()) for r in recs])

    def view_dtype(self) -> str:
        if self.mix['view_precision']:
            return self.mix['view_precision']
        return 'float32' if self.mix['precision'] == 'bfloat16' else 'bfloat16'

    # ------------------------------------------------------------------ correctness
    def release(self):
        self.state = self.train_step = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, precision) -> Dict:
        weights = make_weights(self.cfg, self.seed, self.device)
        batches = [{k: v.to(self.device) for k, v in self.pool[r].items()}
                   for r in self.checked['rows']]
        ctx, ctx_mask = reference.stage_one(self.cfg, weights, batches[0], precision)
        view = reference.view_grads(self.cfg, weights, batches[0], self.ctx, self.mix, precision)
        out = reference.run(self.cfg, weights, batches, self.mix, precision)
        out.update(view_grad=view, ctx=ctx[ctx_mask], ctx_mask=ctx_mask)
        del weights, batches
        gc.collect()
        return out

    def readings(self, got: Dict, ref: Dict):
        """({loss: the widest relative gap of a step's loss; grad: of a
        leaf's first gradient as the optimizer takes it; view_grad: of a
        view-stage leaf's first gradient, the reference's view stage fed the
        program's own stage-1 tokens; change: of a leaf's change over the
        checked steps, leaves whose reference gradient is nought to rounding
        left out; stage1: the RMS gap of stage 1's tokens, as the view stage
        takes them, from the reference's, over the RMS of the reference's},
        where each was widest)."""
        median = statistics.median(ref['grad'].values())
        moved = {n for n, v in ref['grad'].items() if v >= EXCLUDED * median}
        # a control's own tokens, or the program's from its first step
        ctx = got['ctx'] if 'ctx' in got else self.ctx[ref['ctx_mask']]
        loss = max((gap(a, b, 0.0), f'step {k}') for k, (a, b) in
                   enumerate(zip(got['losses'], ref['losses'])))
        values = {'loss_gap': loss, 'grad_gap': leaf_gaps(got['grad'], ref['grad']),
                  'stage1_gap': (rms_gap(ctx, ref['ctx']), 'tokens'),
                  'view_grad_gap': leaf_gaps(got['view_grad'], ref['view_grad']),
                  'change_gap': leaf_gaps(got['change'], ref['change'], moved)}
        where = {k: v[1] for k, v in values.items()}
        where['norms'] = (got.get('norms'), ref['norms'])
        # each leaf left out: its reference gradient over the median leaf's,
        # and the gap of its change as change_gap would read it
        cmed = statistics.median(ref['change'][n] for n in moved)
        where['excluded'] = [(n, ref['grad'][n] / median,
                              gap(got['change'][n], ref['change'][n], cmed))
                             for n in sorted(set(ref['grad']) - moved)]
        return {k: v[0] for k, v in values.items()}, where

    def judge(self, controls=()) -> Dict:
        self.release()
        ref = self.reference(reference.FP32)
        gaps, where = self.readings(self.checked, ref)
        for k in [k for k in gaps if k not in self.cell.limits['limits']]:
            print(f'not compared: {k} {gaps.pop(k)!r}', flush=True)
        finite = all(v == v and abs(v) != float('inf') for v in self.checked['losses'])
        ctl, ctl_where = {}, {}
        for c in controls:
            ctl[c], ctl_where[c.name] = self.readings(self.reference(c), ref)
        return dict(gaps=gaps, finite=finite, controls=ctl, sample=self.checked['rows'],
                    detail=dict(program=where, controls=ctl_where))
