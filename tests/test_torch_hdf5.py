"""The port's HDF5 codec (``renderformer_tpu_torch/io/hdf5.py``) against
h5py, which is only the reference here: files that h5py writes read with
the same bits, files the codec writes read by h5py with the same bits, a
strided row read decodes only the chunks it touches, what is outside the
reader's scope raises, and the scene files of both packages read the same
through both packages' loaders."""

import json
import os

import h5py
import numpy as np
import pytest

from renderformer_tpu.io import h5 as jax_h5
from renderformer_tpu.scene import h5_tools as jax_tools
from renderformer_tpu_torch.io import h5 as port_h5
from renderformer_tpu_torch.io import hdf5
from renderformer_tpu_torch.scene import h5_tools as port_tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT128 = os.path.join(REPO, 'datasets', 'ft128', 'json')
RNG = np.random.default_rng(0)
# every dtype of the reader's scope, as arrays and as scalars
ARRAYS = {
    'i1': RNG.integers(-128, 128, (5, 3), dtype=np.int8),
    'u1': RNG.integers(0, 256, (4,), dtype=np.uint8),
    'i2': RNG.integers(-2 ** 15, 2 ** 15, (3, 2, 2), dtype=np.int16),
    'u2': RNG.integers(0, 2 ** 16, (6,), dtype=np.uint16),
    'i4': RNG.integers(-2 ** 31, 2 ** 31, (2, 5), dtype=np.int32),
    'u4': RNG.integers(0, 2 ** 32, (3,), dtype=np.uint32),
    'i8': RNG.integers(-2 ** 62, 2 ** 62, (4, 1), dtype=np.int64),
    'u8': RNG.integers(0, 2 ** 63, (2,), dtype=np.uint64),
    'f2': RNG.normal(size=(7, 3)).astype(np.float16),
    'f4': RNG.normal(size=(2, 3, 4)).astype(np.float32),
    'f8': RNG.normal(size=(9,)),
    'bool': RNG.uniform(size=(3, 3)) > 0.5,
    'bytes': np.array([b'ab', b'cde', b'']),
}
SCALARS = {'s_i8': np.int64(-7), 's_f8': np.float64(2.5), 's_f2': np.float16(0.1),
           's_bool': np.bool_(True), 's_u1': np.uint8(200), 's_bytes': np.bytes_(b'hello')}
# textures laid out as the scene converter writes them (a per-face constant
# times the patch mask) over the 1,793 triangles of ft128's
# random_scene_0_sphere3: SCENE_TEXTURE at its 32 x 32 patches; TEXTURE at
# 12 x 12, so that h5py's (225, 2, 8, 8) chunks leave partial chunks on
# every axis
SCENE_TEXTURE = (RNG.uniform(size=(1793, 13, 1, 1)).astype(np.float16)
                 * (np.add.outer(np.arange(32), np.arange(32)) <= 32)).astype(np.float16)
TEXTURE = np.ascontiguousarray(SCENE_TEXTURE[:, :, :12, :12])


def same(a, b):
    """Equal values, dtypes and shapes, and the same bits."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and (a.tobytes() == b.tobytes() if a.dtype != object else a.tolist() == b.tolist()))


@pytest.fixture(scope='module')
def h5py_file(tmp_path_factory):
    """A file of h5py's with every structure of the reader's scope."""
    path = str(tmp_path_factory.mktemp('h5py') / 'all.h5')
    with h5py.File(path, 'w') as f:
        for k, v in {**ARRAYS, **SCALARS}.items():
            f.create_dataset(k, data=v)
        f.create_dataset('vlen', data=b'variable length')   # h5py stores bytes so
        for level in (0, 1, 9):
            for shuffle in (False, True):
                f.create_dataset(f'gzip{level}_shuffle{int(shuffle)}', data=ARRAYS['f4'],
                                 compression='gzip', compression_opts=level, shuffle=shuffle)
        f.create_dataset('texture', data=TEXTURE, chunks=(225, 2, 8, 8), compression='gzip',
                         compression_opts=9)
        f.create_dataset('fletcher', data=ARRAYS['i4'], fletcher32=True, chunks=(1, 5))
        f.create_dataset('unwritten', shape=(10, 3), dtype='f4', chunks=(4, 3), fillvalue=7.5)
        f.create_dataset('unwritten_flat', shape=(4,), dtype='i2')
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((4, 3))
        compact = h5py.h5d.create(f.id, b'compact', h5py.h5t.IEEE_F32LE, space, dcpl=dcpl)
        compact.write(h5py.h5s.ALL, h5py.h5s.ALL, ARRAYS['f4'].reshape(-1)[:12].reshape(4, 3))
        g = f.create_group('outer/inner')
        g['x'] = ARRAYS['f8']
        g.attrs['__json__'] = True
        g.attrs['vector'] = np.arange(4.0)
        g.attrs['text'] = 'a str attribute'
        f['outer'].attrs['count'] = np.int32(3)
        f.create_dataset('many_attrs', data=1)
        f.create_dataset('after', data=2)   # so that the header cannot grow in place
        for i in range(60):   # more than the object header's first block holds
            f['many_attrs'].attrs[f'a{i:02d}'] = np.arange(i + 1)
    return path


def test_h5py_files_read_with_the_same_bits(h5py_file):
    with h5py.File(h5py_file, 'r') as ref, hdf5.File(h5py_file, 'r') as got:
        assert got.keys() == list(ref.keys())
        for k, v in {**ARRAYS, **SCALARS}.items():
            assert same(got[k][()], ref[k][()]) and same(got[k][()], v), k
            assert type(got[k][()]) is type(ref[k][()]), k
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        assert got['vlen'][()] == ref['vlen'][()] == b'variable length'
        assert h5py.h5o.get_info(ref['many_attrs'].id).hdr.nchunks > 1   # a continuation block
        for name in ('gzip0_shuffle0', 'gzip0_shuffle1', 'gzip1_shuffle0', 'gzip1_shuffle1',
                     'gzip9_shuffle0', 'gzip9_shuffle1', 'texture', 'fletcher', 'unwritten',
                     'unwritten_flat', 'compact'):
            assert got[name].chunks == ref[name].chunks, name
            assert same(got[name][()], ref[name][()]), name
            assert same(np.asarray(got[name]), ref[name][:]), name
        assert same(got['unwritten'][()], np.full((10, 3), 7.5, np.float32))
        inner = got['outer/inner']
        assert isinstance(inner, hdf5.Group) and 'outer/inner/x' in got and 'nope' not in got
        assert same(inner['x'][()], ARRAYS['f8'])
        want = dict(ref['outer/inner'].attrs)
        assert set(inner.attrs) == set(want)
        for k, v in want.items():
            assert type(inner.attrs[k]) is type(v) and np.array_equal(inner.attrs[k], v), k
        assert inner.attrs.get('__json__') is np.True_ and got['outer'].attrs['count'] == 3
        assert len(got['many_attrs'].attrs) == 60
        assert same(got['many_attrs'].attrs['a59'], ref['many_attrs'].attrs['a59'])
        for sel in (-1, slice(5, 300), slice(3, None, 28), slice(0, 0)):
            assert same(got['texture'][sel], ref['texture'][sel]), sel


def test_files_it_writes_read_in_h5py_with_the_same_bits(tmp_path):
    path = str(tmp_path / 'port.h5')
    many = {f'g{i:03d}': np.int16(i) for i in range(300)}   # 38 symbol nodes, two B-tree levels
    with hdf5.File(path, 'w') as f:
        for k, v in {**ARRAYS, **SCALARS}.items():
            f.create_dataset(k, data=v)
        for level in (0, 1, 9):
            f.create_dataset(f'gzip{level}', data=TEXTURE[:300], compression='gzip',
                             compression_opts=level)
        f.create_dataset('texture', data=SCENE_TEXTURE, compression='gzip', compression_opts=1)
        f.create_dataset('empty', data=np.zeros((0, 3), np.float32), compression='gzip')
        g = f.create_group('outer/inner')
        g['x'] = ARRAYS['f8']
        g.attrs['__json__'] = True
        g.attrs['vector'] = np.arange(4.0)
        f['outer'].attrs['count'] = np.int32(3)
        for k, v in many.items():
            f[f'many/{k}'] = v
    with h5py.File(path, 'r') as ref:
        for k, v in {**ARRAYS, **SCALARS}.items():
            assert same(ref[k][()], v) and type(ref[k][()]) is type(np.asarray(v)[()]), k
        for level in (0, 1, 9):
            ds = ref[f'gzip{level}']
            assert ds.compression == 'gzip' and ds.compression_opts == level
            assert same(ds[()], TEXTURE[:300])
        # whole rows of about 1 MiB a chunk: 39 rows of 26,624 bytes
        assert ref['texture'].chunks == (39, 13, 32, 32)
        assert same(ref['texture'][()], SCENE_TEXTURE) and ref['empty'].shape == (0, 3)
        assert same(ref['outer/inner/x'][()], ARRAYS['f8'])
        assert ref['outer/inner'].attrs['__json__'] is np.True_
        assert same(ref['outer/inner'].attrs['vector'], np.arange(4.0))
        assert ref['outer'].attrs['count'] == 3
        assert list(ref['many']) == sorted(many)
        assert all(ref[f'many/{k}'][()] == v for k, v in many.items())
    with hdf5.File(path, 'r') as got:   # and back through the codec
        assert same(got['texture'][()], SCENE_TEXTURE) and got['many/g299'][()] == 299


def test_strided_row_read_decodes_only_the_chunks_it_touches(tmp_path, h5py_file):
    path = str(tmp_path / 'port.h5')
    with hdf5.File(path, 'w') as f:
        f.create_dataset('texture', data=SCENE_TEXTURE, compression='gzip', compression_opts=1)
    stride = SCENE_TEXTURE.shape[0] // 64   # io/h5._geometry_digest's texture sample
    rows = np.arange(0, SCENE_TEXTURE.shape[0], stride)
    with hdf5.File(path, 'r') as f:
        ds = f['texture']
        assert same(ds[::stride], SCENE_TEXTURE[::stride])
        # stride 28 < 39 rows a chunk: every chunk holding a sampled row, no other
        assert ds.decoded == len(np.unique(rows // ds.chunks[0])) == 46
        ds.decoded = 0
        assert same(ds[100], SCENE_TEXTURE[100]) and ds.decoded == 1
        ds.decoded = 0
        # stride 100 > 39: one chunk a sampled row
        assert same(ds[::100], SCENE_TEXTURE[::100])
        assert ds.decoded == len(SCENE_TEXTURE[::100]) == 18
    with hdf5.File(h5py_file, 'r') as f:
        ds = f['texture']   # h5py's chunks split the inner axes too: 7 x 2 x 2 a row block
        assert same(ds[::stride], TEXTURE[::stride])
        assert ds.decoded == len(np.unique(rows // 225)) * 7 * 2 * 2


def test_outside_the_scope_raises_a_named_error(tmp_path):
    latest = str(tmp_path / 'latest.h5')
    with h5py.File(latest, 'w', libver='latest') as f:
        f['x'] = np.arange(3)
    with pytest.raises(ValueError, match=r'latest\.h5: superblock version 3'):
        hdf5.File(latest, 'r')
    ordered = str(tmp_path / 'ordered.h5')
    with h5py.File(ordered, 'w', track_order=True) as f:
        f['x'] = np.arange(3)
    with pytest.raises(ValueError, match=r'ordered\.h5: a version 2 object header'):
        hdf5.File(ordered, 'r')['x']
    lzf = str(tmp_path / 'lzf.h5')
    with h5py.File(lzf, 'w') as f:
        f.create_dataset('x', data=np.arange(100), compression='lzf')
    with hdf5.File(lzf, 'r') as f, pytest.raises(ValueError, match=r'lzf\.h5: filter 32000'):
        f['x']
    compound = str(tmp_path / 'compound.h5')
    with h5py.File(compound, 'w') as f:
        f['x'] = np.zeros(2, dtype=[('a', '<i4'), ('b', '<f4')])
        f['be'] = np.arange(3, dtype='>i4')
    with hdf5.File(compound, 'r') as f:
        with pytest.raises(ValueError, match=r'compound\.h5: the compound datatype'):
            f['x']
        with pytest.raises(ValueError, match='big-endian integer'):
            f['be']
    userblock = str(tmp_path / 'userblock.h5')
    with h5py.File(userblock, 'w', userblock_size=512) as f:
        f['x'] = np.arange(3)
    with pytest.raises(ValueError, match=r'userblock\.h5: no HDF5 signature at offset 0'):
        hdf5.File(userblock, 'r')
    corrupt = tmp_path / 'corrupt.h5'
    with h5py.File(corrupt, 'w') as f:
        f.create_dataset('x', data=ARRAYS['i4'], fletcher32=True, chunks=(1, 5))
    body = bytearray(corrupt.read_bytes())
    at = bytes(body).index(ARRAYS['i4'][1].tobytes())
    body[at] ^= 1
    corrupt.write_bytes(bytes(body))
    with hdf5.File(str(corrupt), 'r') as f:
        assert same(f['x'][0], ARRAYS['i4'][0])
        with pytest.raises(ValueError, match=r'corrupt\.h5: a chunk fails its fletcher32'):
            f['x'][1]
    text = tmp_path / 'text.h5'
    text.write_bytes(b'not an HDF5 file at all')
    with pytest.raises(ValueError, match='not an HDF5 file'):
        hdf5.File(str(text), 'r')
    with pytest.raises(ValueError, match='dtype <U1'):
        hdf5.File(str(tmp_path / 'w.h5'), 'w').create_dataset('u', data=np.array(['a']))


def test_scene_files_read_the_same_through_both_packages(tmp_path):
    """The JAX package's save_scene_h5 (h5py) and the port's, and each
    package's save_dict_to_h5, read through both packages' loaders."""
    n = 100
    scene = dict(triangles=RNG.normal(size=(n, 3, 3)).astype(np.float32),
                 vn=RNG.normal(size=(n, 3, 3)).astype(np.float32),
                 texture=RNG.uniform(size=(n, 13, 32, 32)).astype(np.float32),
                 c2w=RNG.normal(size=(2, 4, 4)).astype(np.float32),
                 fov=np.array([40.0, 50.0], np.float32))
    paths = {'jax': str(tmp_path / 'jax.h5'), 'port': str(tmp_path / 'port.h5')}
    jax_h5.save_scene_h5(paths['jax'], **scene)
    port_h5.save_scene_h5(paths['port'], **scene)
    want = jax_h5.load_scene_h5(paths['jax'], padding_length=128)
    for p in paths.values():
        for load in (jax_h5.load_scene_h5, port_h5.load_scene_h5):
            got = load(p, padding_length=128)
            assert set(got) == set(want)
            assert all(same(got[k], want[k]) for k in want), (p, load.__module__)
        assert same(jax_h5.load_cameras_h5(p)[0], port_h5.load_cameras_h5(p)[0])
    assert port_h5._geometry_digest(paths['jax']) == port_h5._geometry_digest(paths['port'])
    assert port_h5.probe_static_scene([paths['jax'], paths['port']])

    data = {'name': 'scene', 'none': None, 'ints': [1, 2, 3], 'floats': [0.5, 1.5],
            'mixed': ['a', 1, None], 'nested': {'flag': True, 'count': 7, 'scale': 0.25,
                                               'deeper': {'text': 'x', 'pos': [[0, 1], [2, 3]]}}}
    dicts = {'jax': str(tmp_path / 'jax_dict.h5'), 'port': str(tmp_path / 'port_dict.h5')}
    jax_tools.save_dict_to_h5(data, dicts['jax'])
    port_tools.save_dict_to_h5(data, dicts['port'])
    want = jax_tools.load_dict_from_h5(dicts['jax'])
    for p in dicts.values():
        for load in (jax_tools.load_dict_from_h5, port_tools.load_dict_from_h5):
            got = load(p)
            assert json.dumps(got, sort_keys=False) == json.dumps(want, sort_keys=False), p
            assert type(got['nested']['flag']) is type(want['nested']['flag'])


def test_ft128_scene_converts_as_the_jax_package_converts_it(tmp_path, monkeypatch):
    """The smallest ft128 scene (525 triangles), converted from the repo
    root by each package's generator function: the same arrays; and the
    port's gzip-9 files within 1.5x the size h5py writes for the same
    arrays (here and for the 1,793-triangle sphere3)."""
    monkeypatch.chdir(REPO)   # the JSONs name examples/ relative to the repo root
    sizes = {}
    for name in ('random_scene_100_obj2', 'random_scene_0_sphere3'):
        with open(os.path.join(FT128, f'{name}.json')) as f:
            scene = json.load(f)
        port = str(tmp_path / f'{name}_port.h5')
        port_tools.save_dict_to_h5_renderformer_method(scene, port, '')
        got = port_h5.load_scene_h5(port, texture_dtype=np.float16)
        if name == 'random_scene_100_obj2':
            jax = str(tmp_path / f'{name}_jax.h5')
            jax_tools.save_dict_to_h5_renderformer_method(scene, jax, '')
            want = jax_h5.load_scene_h5(jax, texture_dtype=np.float16)
            assert got['triangles'].shape[0] == 525
            assert all(same(got[k], want[k]) for k in want), name
        ref = str(tmp_path / f'{name}_h5py.h5')
        with h5py.File(ref, 'w') as f:
            for k in ('triangles', 'vn', 'texture', 'c2w', 'fov'):
                f.create_dataset(k, data=got[k], compression='gzip', compression_opts=9)
        sizes[name] = os.path.getsize(port) / os.path.getsize(ref)
    assert max(sizes.values()) <= 1.5, sizes
