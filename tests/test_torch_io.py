"""The port's IO and host utilities against the JAX package's: EXR bytes,
PNG pixels (decoded by cv2), H5 scenes and folders, tone mappers, and the
prefetch thread and writer pool."""

import contextlib
import os
import time

import cv2
import numpy as np
import pytest

from renderformer_tpu.io import h5 as jax_h5
from renderformer_tpu.io import image as jax_image
from renderformer_tpu.utils import tone_map as jax_tone_map
from renderformer_tpu_torch.io import h5 as port_h5
from renderformer_tpu_torch.io import image as port_image
from renderformer_tpu_torch.utils import tone_map as port_tone_map
from renderformer_tpu_torch.utils.prefetch import AsyncWriter, prefetch
from renderformer_tpu_torch.utils.profiling import ThroughputMeter


def _hdr(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(-1.0, 2.0, (h, w, 3)).astype(np.float32)
    img[0, 0] = [0.0, 65504.0, 1e-8]
    return img


# -- EXR -----------------------------------------------------------------

@pytest.mark.parametrize('compression', ['zip', 'zips', 'none'])
@pytest.mark.parametrize('hw', [(32, 32), (37, 21), (1, 5)])
def test_exr_bytes_equal_jax(tmp_path, compression, hw):
    img = _hdr(*hw)
    port_image.write_exr(str(tmp_path / 'p.exr'), img, compression=compression)
    jax_image.write_exr(str(tmp_path / 'j.exr'), img, compression=compression)
    assert (tmp_path / 'p.exr').read_bytes() == (tmp_path / 'j.exr').read_bytes()
    np.testing.assert_array_equal(port_image.read_exr(str(tmp_path / 'j.exr')), img)
    np.testing.assert_array_equal(jax_image.read_exr(str(tmp_path / 'p.exr')), img)


def test_exr_rejects_a_wrong_shape(tmp_path):
    with pytest.raises(ValueError):
        port_image.write_exr(str(tmp_path / 'p.exr'), np.zeros((4, 4), np.float32))


# -- PNG -----------------------------------------------------------------

@pytest.mark.parametrize('shape', [(32, 32, 3), (17, 5, 3), (1, 1, 3), (23, 9), (64, 64)])
def test_png_decodes_to_its_pixels_and_to_jax(tmp_path, shape):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img.reshape(-1)[:2] = [0, 255]
    port_image.write_png(str(tmp_path / 'sub' / 'p.png'), img)
    jax_image.write_png(str(tmp_path / 'j.png'), img)
    got = cv2.imread(str(tmp_path / 'sub' / 'p.png'), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / 'j.png'), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        got, want = got[:, :, ::-1], want[:, :, ::-1]
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('bad', [np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.float32),
                                 np.zeros(4, np.uint8)], ids=['rgba', 'float', '1d'])
def test_png_rejects_what_it_cannot_write(tmp_path, bad):
    with pytest.raises(ValueError):
        port_image.write_png(str(tmp_path / 'p.png'), bad)


def test_video_writes_frames(tmp_path):
    frames = [np.full((16, 16, 3), 40 * i, np.uint8) for i in range(4)]
    port_image.write_video(str(tmp_path / 'v.mp4'), frames, fps=4)
    cap = cv2.VideoCapture(str(tmp_path / 'v.mp4'))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == len(frames)


# -- H5 scenes -------------------------------------------------------------

def _scene(n_tris, n_views, seed):
    rng = np.random.default_rng(seed)
    return dict(triangles=rng.normal(size=(n_tris, 3, 3)).astype(np.float32),
                vn=rng.normal(size=(n_tris, 3, 3)).astype(np.float32),
                texture=rng.uniform(0, 4, (n_tris, 13, 32, 32)).astype(np.float32),
                c2w=rng.normal(size=(n_views, 4, 4)).astype(np.float32),
                fov=rng.uniform(30, 60, n_views).astype(np.float32))


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('padding', [None, 9])
def test_h5_round_trip_against_jax(tmp_path, writer, padding):
    s = _scene(5, 2, 0)
    save = port_h5.save_scene_h5 if writer == 'port' else jax_h5.save_scene_h5
    path = str(tmp_path / 'deep' / 'scene.h5')
    save(path, s['triangles'], s['vn'], s['texture'], s['c2w'], s['fov'])
    got = port_h5.load_scene_h5(path, padding)
    _assert_dicts_equal(got, jax_h5.load_scene_h5(path, padding))
    assert got['mask'].sum() == 5 and got['triangles'].shape[0] == (padding or 5)
    np.testing.assert_array_equal(got['texture'][:5], s['texture'].astype(np.float16))
    half = port_h5.load_scene_h5(path, padding, texture_dtype=np.float16)
    assert half['texture'].dtype == np.float16
    np.testing.assert_array_equal(port_h5.load_cameras_h5(path)[0], s['c2w'])
    with pytest.raises(ValueError):
        port_h5.load_scene_h5(path, padding_length=4)


def test_h5_folder_order_and_datasets_match_jax(tmp_path):
    names = ['frame_10.h5', 'frame_2.h5', 'Frame_1.h5', 'frame_002b.h5', 'a.txt']
    for i, name in enumerate(names):
        s = _scene(4 + i, 2, i)
        if name.endswith('.h5'):
            port_h5.save_scene_h5(str(tmp_path / name), s['triangles'], s['vn'],
                                  s['texture'], s['c2w'], s['fov'])
        else:
            (tmp_path / name).write_text('not a scene')
    files = port_h5.list_scene_files(str(tmp_path))
    assert files == jax_h5.list_scene_files(str(tmp_path))
    assert [os.path.basename(f) for f in files] == [
        'Frame_1.h5', 'frame_2.h5', 'frame_002b.h5', 'frame_10.h5']
    got = list(port_h5.SceneFolderDataset(str(tmp_path), 12).batches(3))
    want = list(jax_h5.SceneFolderDataset(str(tmp_path), 12).batches(3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_dicts_equal(g, w)
    assert port_h5.probe_static_scene(files) == jax_h5.probe_static_scene(files) is False
    assert port_h5.probe_static_scene(files[:1]) is True


def test_video_dataset_matches_jax(tmp_path):
    s = _scene(6, 1, 0)
    rng = np.random.default_rng(5)
    for i in range(5):
        port_h5.save_scene_h5(str(tmp_path / f'f_{i}.h5'), s['triangles'], s['vn'],
                              s['texture'], rng.normal(size=(1 + i % 2, 4, 4)),
                              np.full(1 + i % 2, 30.0 + i))
    files = port_h5.list_scene_files(str(tmp_path))
    assert port_h5.probe_static_scene(files) is True
    got_ds, want_ds = port_h5.VideoSceneDataset(str(tmp_path)), jax_h5.VideoSceneDataset(
        str(tmp_path))
    _assert_dicts_equal(got_ds.scene, want_ds.scene)
    got, want = list(got_ds.view_chunks(3)), list(want_ds.view_chunks(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_dicts_equal(g, w)
    assert got[-1]['n_valid'] == 1
    # a later frame whose texture differs is refused
    port_h5.save_scene_h5(str(tmp_path / 'f_9.h5'), s['triangles'], s['vn'],
                          s['texture'] + 1, np.eye(4)[None], np.full(1, 30.0))
    with pytest.raises(ValueError, match='not a static scene'):
        list(port_h5.VideoSceneDataset(str(tmp_path)).view_chunks(3))


# -- tone mapping ------------------------------------------------------------

@pytest.mark.parametrize('name', ['agx', 'filmic', 'pbr_neutral', 'Khronos PBR Neutral'])
def test_tone_mappers_equal_jax(name):
    hdr = _hdr(19, 23, seed=3)
    hdr[1, 1] = [-1.0, 0.0, 1e4]
    with pytest.warns(UserWarning) if name == 'filmic' else contextlib.nullcontext():
        port = port_tone_map.ToneMapper(name)
    jax_mapper = jax_tone_map.ToneMapper.__new__(jax_tone_map.ToneMapper)
    jax_mapper._fn = jax_tone_map._TONE_MAPPERS[name]
    got, want = port.hdr_to_ldr(hdr), jax_mapper.hdr_to_ldr(hdr)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unknown_tone_mapper_raises():
    with pytest.raises(ValueError, match='unknown tone mapper'):
        port_tone_map.ToneMapper('reinhard')


# -- prefetch and the writer pool (as tests/test_prefetch.py) ----------------

def test_prefetch_preserves_order_and_values():
    assert list(prefetch(range(100), depth=4)) == list(range(100))


def test_prefetch_propagates_source_errors():
    def gen():
        yield 1
        yield 2
        raise ValueError('boom')

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match='boom'):
        next(it)


def test_prefetch_overlaps_producer_with_consumer():
    def slow_gen():
        for i in range(6):
            time.sleep(0.05)
            yield i

    t0 = time.time()
    for _ in prefetch(slow_gen(), depth=2):
        time.sleep(0.05)
    assert time.time() - t0 < 0.5  # serial would be ~0.6 s


def test_async_writer_runs_and_drains():
    out = {}
    w = AsyncWriter(max_workers=2)
    for i in range(20):
        w.submit(out.__setitem__, i, i * i)
    w.close()
    assert out == {i: i * i for i in range(20)}


def test_async_writer_raises_on_drain():
    def fail():
        raise OSError('disk full')

    w = AsyncWriter(max_workers=1)
    w.submit(fail)
    with pytest.raises(OSError, match='disk full'):
        w.drain()
    with pytest.raises(OSError, match='disk full'):
        w.close()


def test_throughput_meter_matches_jax():
    from renderformer_tpu.utils.profiling import ThroughputMeter as JaxMeter
    got, want = ThroughputMeter(512, 8, 2, 2048), JaxMeter(512, 8, 2, 2048)
    got._times = want._times = [0.5, 0.1, 0.2, 0.4]
    assert got.summary() == want.summary()
    assert got.summary(warmup=9) == want.summary(warmup=9)
    with pytest.raises(RuntimeError):
        ThroughputMeter().stop()
