"""Faults planted in the program under test, to see the comparison catch them.

Each is a context manager that patches the program's modules in this
process only (no file changes):

* ``unchanged_state``: the train step's optimizer update does nothing, so
  the step hands its state back unchanged;
* ``half_batch``: the train step's loss is the mean over the first half of
  the image rows only, the other half of the batch's rays left out;
* ``altered_image``: where a render's image is produced (``render_fn``),
  its first view comes out mirrored;
* ``altered_gradient``: where the train step hands its gradients to the
  optimizer, the first leaf's comes out doubled.

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def unchanged_state():
    from renderformer_tpu_torch.training import state
    with _patched(state.AdamW, 'update', lambda self, *a, **k: None):
        yield


class _HalfMean:
    """The torch module, but ``mean`` averages the first half of the rows
    of an image-shaped [B, V, H, W, C] tensor."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def mean(self, x, *args, **kwargs):
        if x.dim() == 5 and not args and not kwargs:
            return self._torch.mean(x[:, :, :x.shape[2] // 2])
        return self._torch.mean(x, *args, **kwargs)


@contextlib.contextmanager
def half_batch():
    from renderformer_tpu_torch.training import state
    with _patched(state, 'torch', _HalfMean(state.torch)):
        yield


@contextlib.contextmanager
def altered_image():
    from renderformer_tpu_torch.pipelines import rendering_pipeline as rp
    original = rp.render_fn

    def render_fn(*args, **kwargs):
        img = original(*args, **kwargs)
        return rp.torch.cat([img[:, :1].flip(-2), img[:, 1:]], dim=1)

    with _patched(rp, 'render_fn', render_fn):
        yield


@contextlib.contextmanager
def altered_gradient():
    from renderformer_tpu_torch.training import state
    original = state.AdamW.update

    def update(self, grads, *args, **kwargs):
        grads[0].mul_(2.0)
        return original(self, grads, *args, **kwargs)

    with _patched(state.AdamW, 'update', update):
        yield


FAULTS = {'unchanged_state': unchanged_state, 'half_batch': half_batch,
          'altered_image': altered_image, 'altered_gradient': altered_gradient}
