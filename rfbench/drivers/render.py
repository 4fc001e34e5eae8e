"""The render client: a closed loop of one client with one render in flight.

It hands ``RenderingPipeline.render`` a scene's numpy arrays, as ``infer``
and ``batch_infer`` do after reading H5, so the upload is part of each
request; while the device renders request i the client fetches request
i-1's image to the host, as ``batch_infer``'s ``Output`` does, and a
reader thread makes the next requests' scenes, each anew, two ahead, as
``batch_infer`` reads its next files (their textures into a ring of host
buffers, written before the window, as a reader reuses its memory).  A request's latency runs from the
hand-off of its scene to its image on the host.  The pipeline runs at its
defaults (``RuntimeConfig()``: bf16 stage 1 and view stage, the composed
DPT tail, the norms in torch ops).
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from rfbench import counts, scenes
from rfbench.reference import model as reference
from rfbench.weights import make_weights

VIEW_RANGE = 'rfbench.view_transformer'
AHEAD = 2          # scenes the reader thread makes ahead of the request in flight
SLOTS = AHEAD + 2  # texture buffers: no request's is written again before its render returns


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The RMS of a - b, float64 sums."""
    return float((a.double() - b.double()).pow(2).mean().sqrt())


class Driver:
    def __init__(self, cell, seed: int, device: str = 'cuda'):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.model, cell.mix
        self.records: List[Dict] = []
        self.kept: List = []          # a seeded reservoir of (request, image) of the window
        self.longest = None           # one request of the largest scene, with its image
        self.seen = [0, 0]            # requests finished, of them of the largest scene
        self.next = 0
        self.launches: Dict[tuple, int] = {}
        self.attempted = self.failed = 0
        self.phases: List = []

    # ------------------------------------------------------------------ set-up
    def build(self):
        """The pipeline over seeded weights made on the device, the model
        built on ``meta`` and the weights assigned."""
        from renderformer_tpu_torch import RenderingPipeline, RuntimeConfig
        from renderformer_tpu_torch.config import RenderFormerConfig
        from renderformer_tpu_torch.models.renderformer import RenderFormer
        weights = make_weights(self.cfg, self.seed, self.device)
        with torch.device('meta'):
            model = RenderFormer(RenderFormerConfig.from_dict(self.cfg))
        model.load_state_dict(weights, strict=True, assign=True)
        return RenderingPipeline(model, RuntimeConfig(), device=self.device)

    def setup(self):
        self.pipe = self.build()
        self.draw = scenes.rng(self.seed, 'sample')
        self.mark('model')
        sizes = self.mix['triangles']
        count = self.mix['max_requests']
        self.c2w, self.fov = scenes.request_cameras(self.seed, self.mix, count)
        self.order = scenes.order(self.seed, len(sizes), count)
        self.reader = concurrent.futures.ThreadPoolExecutor(1, 'rfbench-reader')
        self.ahead, self.made = collections.deque(), 0
        shape = (1, max(sizes), scenes.CHANNELS, scenes.PATCH, scenes.PATCH)
        self.slots = [np.ones(shape, np.float32) for _ in range(SLOTS)]
        self.mark('scenes')
        # every scene size once, on scenes and cameras no request uses
        warm_c2w, warm_fov = scenes.request_cameras(self.seed + 1, self.mix, len(sizes))
        for k, n in enumerate(sizes):
            scene = scenes.render_scene(self.seed, self.mix, k, n, stream='warm')
            self.counted(lambda: self.pipe.render(
                scene['triangles'], scene['texture'], scene['mask'], scene['vn'], warm_c2w[k],
                warm_fov[k], resolution=self.mix['resolution']).cpu(), scene)
        self.sync()
        self.mark('warm-up')

    def counted(self, fn, scene):
        """fn() with the kernel launches it makes recorded by scene size."""
        from renderformer_tpu_torch import ops
        before = dict(ops.LAUNCHES)
        out = fn()
        key = (scene['mask'].shape[1],) + tuple(
            sorted((k, v - before[k]) for k, v in ops.LAUNCHES.items() if v != before[k]))
        self.launches[key] = self.launches.get(key, 0) + 1
        return out

    def mark(self, phase: str) -> None:
        self.sync()
        self.phases.append((phase, time.perf_counter()))

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ traffic
    def submit(self):
        i = self.next
        self.next += 1
        scene, c2w, fov = self.prefetched(i)
        self.attempted += 1
        t = time.perf_counter()
        try:
            out = self.counted(lambda: self.pipe.render(
                scene['triangles'], scene['texture'], scene['mask'], scene['vn'], c2w, fov,
                resolution=self.mix['resolution']), scene)
        except RuntimeError as e:
            print(f'request {i} failed: {e}', flush=True)
            self.failed += 1
            out = None
        return i, scene, t, out

    def request(self, i: int, out=None):
        """Request i's scene, made anew, and its cameras (the sizes and
        cameras repeat after ``max_requests``)."""
        k = i % len(self.order)
        n = self.mix['triangles'][self.order[k]]
        return (scenes.render_scene(self.seed, self.mix, i, n, out=out),
                self.c2w[k], self.fov[k])

    def prefetched(self, i: int):
        """Request i's inputs from the reader thread, which keeps ``AHEAD``
        more in the making; requests are taken in order, and request i's
        texture buffer is written again for request i + SLOTS only."""
        while self.made <= i + AHEAD:
            out = self.slots[self.made % SLOTS]
            self.ahead.append(self.reader.submit(self.request, self.made, out))
            self.made += 1
        return self.ahead.popleft().result()

    def finish(self, pending, keep: bool = True):
        i, scene, t, out = pending
        n = scene['mask'].shape[1]
        rec = dict(i=i, n=n, t_submit=t, ok=out is not None,
                   rays=self.mix['views'] * self.mix['resolution'] ** 2,
                   flops=counts.render_flops(self.cfg, n, self.mix['views'],
                                             self.mix['resolution']))
        if out is not None:
            img = out.cpu().numpy()
            rec['t_done'] = time.perf_counter()
            if keep:
                self.keep(i, n, img)
        else:
            rec['t_done'] = float('inf')
        return rec

    def loop(self, until: float, count: int = 0, keep: bool = True) -> List[Dict]:
        """Requests, one in flight, until the clock passes ``until`` (or
        ``count`` have been sent); returns their records once all are back."""
        recs, pending, sent = [], None, 0

        def more():
            return sent < count if count else time.perf_counter() < until

        while more():
            nxt = self.submit()
            sent += 1
            if pending is not None:
                recs.append(self.finish(pending, keep))
            pending = nxt
        if pending is not None:
            recs.append(self.finish(pending, keep))
        return recs

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        self.records = self.loop(t0 + seconds)
        done = [r['t_done'] for r in self.records if r['ok']]
        return dict(t0=t0, t_end=max(done) if done else time.perf_counter(),
                    records=self.records)

    def view_transformers(self) -> List[torch.nn.Module]:
        """The view transformer of every model the pipeline holds: its
        master and the copies it cast for a render's dtypes."""
        found = {}
        for v in vars(self.pipe).values():
            for m in (v.values() if isinstance(v, dict) else (v,)):
                if isinstance(m, torch.nn.Module) and hasattr(m, 'view_transformer'):
                    found[id(m.view_transformer)] = m.view_transformer
        return list(found.values())

    def tail(self, requests: int = 3) -> Dict:
        """``requests`` more requests with a host range around each call of
        the view transformer (forward hooks of the benchmark's own, on those
        modules alone)."""
        from torch.autograd.profiler import record_function
        open_ranges = []

        def pre(mod, args):
            open_ranges.append(record_function(VIEW_RANGE).__enter__())

        def post(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        hooks = [h for m in self.view_transformers()
                 for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
        try:
            recs = self.loop(0.0, count=requests, keep=False)
        finally:
            for h in hooks:
                h.remove()
        return dict(records=recs, sites=[counts.render_sites(self.cfg, r['n'], self.mix['views'],
                                                             self.mix['resolution'])
                                         for r in recs])

    # ------------------------------------------------------------------ correctness
    def keep(self, i: int, n: int, img: np.ndarray) -> None:
        """Reservoir sampling, seeded: every finished request of the window
        is equally likely to be among the ``sample - 1`` kept, and one of
        the largest scene's is kept besides; the other images are dropped
        as a client drops them once written."""
        k = self.cell.limits['sample'] - 1
        t = self.seen[0]
        self.seen[0] += 1
        if len(self.kept) < k:
            self.kept.append((i, img))
        else:
            j = int(self.draw.integers(t + 1))
            if j < k:
                self.kept[j] = (i, img)
        if n == max(self.mix['triangles']):
            t = self.seen[1]
            self.seen[1] += 1
            if int(self.draw.integers(t + 1)) == 0:
                self.longest = (i, img)

    def sample(self) -> Dict[int, np.ndarray]:
        """The requests to compare, with their images: one of the largest
        scene and the reservoir."""
        out = dict(self.kept)
        if self.longest is not None:
            out[self.longest[0]] = self.longest[1]
        return out

    def release(self):
        self.reader.shutdown(wait=True, cancel_futures=True)
        self.ahead.clear()
        self.pipe = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def judge(self, controls=()) -> Dict:
        """The images the timed path returned for the sample, against the
        float32 reference on the same inputs, in log-radiance log10(1 + x):
        for each view, the RMS gap of the program's image over the RMS gap
        of the reference computed at the configuration's precision (the
        limits file's ``unit``) from the float32 one; the widest of these.
        With ``controls``, the reference at those precisions is read the
        same way."""
        images = self.sample()
        self.kept, self.longest = [], None
        self.release()
        weights = make_weights(self.cfg, self.seed, self.device)
        unit = reference.Precision(**self.cell.limits['unit'])
        gaps = {'image_gap_units': 0.0}
        ctl = {c: {'image_gap_units': 0.0} for c in controls}
        finite = True
        res = self.mix['resolution']
        for i, img in sorted(images.items()):
            scene, c2w, fov = self.request(i)
            dev = lambda x: torch.as_tensor(x[0], device=self.device)  # noqa: E731
            args = (dev(scene['triangles']), dev(scene['texture']), dev(scene['mask']),
                    dev(scene['vn']), dev(c2w), dev(fov)[:, 0])
            with torch.no_grad():
                y_ref = torch.log10(reference.render(self.cfg, weights, *args, res) + 1.0)
                y_unit = torch.log10(reference.render(self.cfg, weights, *args, res,
                                                      precision=unit) + 1.0)
                got = torch.as_tensor(img[0], device=self.device)
                finite &= bool(torch.isfinite(got).all())
                outs = [(gaps, got)] + [(ctl[c], reference.render(
                    self.cfg, weights, *args, res, precision=c)) for c in controls]
                for into, out in outs:
                    y = torch.log10(out + 1.0)
                    for v in range(y.shape[0]):
                        ratio = rms(y[v], y_ref[v]) / max(rms(y_unit[v], y_ref[v]), 1e-30)
                        into['image_gap_units'] = max(into['image_gap_units'], ratio)
        return dict(gaps=gaps, finite=finite, controls=ctl, sample=sorted(images))
