"""The port's training dataset against the JAX package's, bit for bit, on
tiny H5 scenes written into a temporary directory: every item, the split,
the batches (shuffled, ``drop_last``, ``pad_last`` with ``valid``) and the
expansion of compact items in a batch with a full one; and ``read_png``
against ``imageio.v3.imread``."""

import os

import imageio
import numpy as np
import pytest

from renderformer_tpu.training.dataset import RenderFormerDataset as JaxDataset
from renderformer_tpu_torch.io.h5 import save_scene_h5
from renderformer_tpu_torch.io.image import read_png, write_png
from renderformer_tpu_torch.training.dataset import (
    RenderFormerDataset, compact_texture, expand_texture_flat, texture_patch_mask)

RES = 32
# (triangles, views, compact texture, GT size or None): 130 triangles put the
# bucket at 256
SCENES = [(5, 1, True, 48), (130, 2, True, 16), (8, 1, False, 32), (12, 1, True, None),
          (9, 2, True, 64)]


def write_scenes(root, scenes=SCENES, seed=0):
    """H5 scenes ``scene_<i>.h5`` and their GT PNGs in ``root``; a compact
    scene has the converter's layout (per-face constants times the patch
    mask), the others random patches."""
    rng = np.random.default_rng(seed)
    mask = texture_patch_mask(32)
    for i, (n, nv, compact, gt) in enumerate(scenes):
        if compact:
            flat = rng.uniform(0, 1, (n, 13)).astype(np.float16).astype(np.float32)
            tex = flat[..., None, None] * mask
        else:
            tex = rng.uniform(0, 1, (n, 13, 32, 32)).astype(np.float32)
        c2w = np.tile(np.eye(4, dtype=np.float32), (nv, 1, 1))
        c2w[:, 2, 3] = 2.0
        save_scene_h5(os.path.join(root, f'scene_{i}.h5'),
                      triangles=rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.3,
                      vn=rng.normal(size=(n, 3, 3)).astype(np.float32), texture=tex,
                      c2w=c2w, fov=np.full((nv,), 40.0, np.float32))
        if gt is not None:
            write_png(os.path.join(root, f'scene_{i}.png'),
                      rng.integers(0, 256, (gt, gt, 3), dtype=np.uint8))


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('scenes'))
    write_scenes(root)
    return (RenderFormerDataset(h5_dir=root, gt_dir=root, max_resolution=RES),
            JaxDataset(h5_dir=root, gt_dir=root, max_resolution=RES))


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_items_are_the_jax_items(datasets):
    port, jax_ds = datasets
    assert len(port) == len(jax_ds) == len(SCENES)
    assert port.padding_length == jax_ds.padding_length == 256
    assert port.texture_patch_size == 32
    for i in range(len(SCENES)):
        got, want = port[i], jax_ds[i]
        assert_same(got, want)
        assert ('texture_flat' in got) == SCENES[i][2]
    # the missing GT is an image of zeros; the small one was upscaled
    assert not port[3]['gt'].any() and port[1]['gt'].any()


def test_split_and_batches_are_the_jax_batches(datasets):
    port, jax_ds = datasets
    assert port.split(0.8, 42) == jax_ds.split(0.8, 42)
    assert port.split(0.5, 3) == jax_ds.split(0.5, 3)
    cases = [dict(batch_size=1, shuffle=True, seed=43),
             dict(batch_size=2, shuffle=True, seed=7),            # drops the last
             dict(batch_size=2, shuffle=True, seed=7, drop_last=False),
             dict(batch_size=3, shuffle=False, pad_last=True)]
    # scenes 1 and 4 have 2 views; batch them apart from the 1-view scenes
    for idx in ([0, 2, 3], [1, 4]):
        for kw in cases:
            got = list(port.batches(idx, **kw))
            want = list(jax_ds.batches(idx, **kw))
            assert len(got) == len(want) > 0, kw
            for g, w in zip(got, want):
                assert_same(g, w)
    (last,) = list(port.batches([0, 2, 3], batch_size=4, shuffle=False, pad_last=True))
    np.testing.assert_array_equal(last['valid'], [1, 1, 1, 0])


@pytest.mark.parametrize('rank', [0, 1])
def test_rank_batches_are_the_jax_rank_batches(datasets, rank):
    """Two ranks: each gets its slice of every global batch (and of
    ``valid``), the JAX package's DistributedSampler equivalent."""
    port, jax_ds = datasets
    idx = [0, 2, 3]
    for kw in (dict(batch_size=2, shuffle=True, seed=7),
               dict(batch_size=2, shuffle=False, pad_last=True)):
        got = list(port.batches(idx, rank=rank, world=2, **kw))
        want = list(jax_ds.batches(idx, rank=rank, world=2, **kw))
        assert len(got) == len(want) > 0, kw
        for g, w in zip(got, want):
            assert_same(g, w)
            assert g['triangles'].shape[0] == 1
    with pytest.raises(ValueError, match='must divide evenly'):
        next(port.batches(idx, batch_size=3, rank=rank, world=2))


def test_mixed_batch_expands_the_compact_items(datasets):
    port, _ = datasets
    (batch,) = list(port.batches([0, 2], batch_size=2, shuffle=False))
    assert 'texture_flat' not in batch and batch['texture'].shape == (2, 256, 13, 32, 32)
    np.testing.assert_array_equal(batch['texture'][0],
                                  expand_texture_flat(port[0]['texture_flat'], 32))
    (compact,) = list(port.batches([0, 3], batch_size=2, shuffle=False))
    assert 'texture' not in compact and compact['texture_flat'].shape == (2, 256, 13)


def test_compact_round_trip():
    rng = np.random.default_rng(1)
    flat = rng.uniform(0, 1, (6, 13)).astype(np.float16)
    tex = expand_texture_flat(flat, 32)
    np.testing.assert_array_equal(compact_texture(tex), flat)
    tex[2, 4, 30, 1] += np.float16(0.5)  # a texel inside the mask moves off the constant
    assert compact_texture(tex) is None


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L'])
def test_read_png_is_imageio(tmp_path, mode):
    rng = np.random.default_rng(2)
    shape = {'RGB': (20, 17, 3), 'RGBA': (20, 17, 4), 'L': (20, 17)}[mode]
    path = str(tmp_path / f'{mode}.png')
    imageio.v3.imwrite(path, rng.integers(0, 256, shape, dtype=np.uint8))
    got, want = read_png(path), imageio.v3.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)
