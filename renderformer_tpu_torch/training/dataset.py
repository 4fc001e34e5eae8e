"""Training dataset: H5 scenes paired with ground-truth renderings.

The counterpart of ``renderformer_tpu/training/dataset.py``: scenes from
``h5_dir/*.h5`` (natural order), the ground truth ``gt_dir/<stem>.png``
resized to ``max_resolution`` (an image of zeros where it is missing),
every scene padded to one triangle bucket (the largest count rounded up
to 128), a RAM cache of decoded items, a seeded split, and batches with
shuffling, ``drop_last`` and ``pad_last`` (with its ``valid`` vector).

Textures with the layout the scene converter writes (a per-face constant
times the lower-triangle patch mask) are kept compact, as ``texture_flat``
[N, 13]; the train step broadcasts them on the device.  A batch is
compact only when every item is; otherwise its compact items are
expanded to the full items' patch size.  ``texture_patch_size`` is the
scenes' patch size, for the trainer to hold against the model's.

``h5py`` is imported by the H5 read (``_list_scenes``, ``_scene_shape``
and ``_read_scene``, which a subclass may replace to read scenes from
elsewhere, as ``InMemoryDataset`` reads arrays), ``cv2`` by the
ground-truth read, so the module imports without either.  Data-parallel runs pass ``batches`` their ``rank`` and
``world``: every rank shuffles alike and takes its slice of each global
batch, as the reference's DistributedSampler deals it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from renderformer_tpu_torch.io.h5 import list_scene_files, load_scene_h5, pad_scene
from renderformer_tpu_torch.io.image import read_png

PATCH_SIZE = 32
BUCKET = 128  # triangle counts are padded to a multiple of this

_UPSCALE_WARNED = set()


def texture_patch_mask(size: int = PATCH_SIZE) -> np.ndarray:
    """The lower-triangle texel mask of a patch, x + y <= size (bool)."""
    x, y = np.meshgrid(np.arange(size), np.arange(size), indexing='ij')
    return (x + y) <= size


def compact_texture(texture: np.ndarray) -> Optional[np.ndarray]:
    """[N, 13, ps, ps] -> [N, 13] when every patch is its per-face constant
    times the patch mask (checked bit for bit), else None."""
    ps = texture.shape[-1]
    m = texture_patch_mask(ps)
    v = texture[:, :, 0, 0]
    if np.array_equal(v[:, :, None, None] * m.astype(texture.dtype), texture):
        return v
    return None


def expand_texture_flat(flat: np.ndarray, ps: int = PATCH_SIZE) -> np.ndarray:
    """Inverse of :func:`compact_texture`, on the host."""
    m = texture_patch_mask(ps).astype(flat.dtype)
    return flat[..., None, None] * m


def _load_gt(path: str, resolution: int) -> np.ndarray:
    """The ground truth as fp32 RGB in [0, 1] at ``resolution``^2: cv2's
    INTER_AREA to shrink it, INTER_LINEAR, with a warning once per size, to
    grow it."""
    img = np.asarray(read_png(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.shape[0] != resolution or img.shape[1] != resolution:
        import cv2
        if img.shape[0] >= resolution and img.shape[1] >= resolution:
            img = cv2.resize(img, (resolution, resolution), interpolation=cv2.INTER_AREA)
        else:
            key = (img.shape[0], img.shape[1], resolution)
            if key not in _UPSCALE_WARNED:
                _UPSCALE_WARNED.add(key)
                print(f'WARNING: GT {path} is {img.shape[1]}x{img.shape[0]} '
                      f'< target {resolution}^2 — upscaling a ground-truth '
                      f'image blurs the loss target; re-render GT at '
                      f'>= the training resolution')
            img = cv2.resize(img, (resolution, resolution), interpolation=cv2.INTER_LINEAR)
    return img.astype(np.float32)


class RenderFormerDataset:
    """Scene + ground-truth pairs, padded to one triangle bucket."""

    def __init__(self, h5_dir: str, gt_dir: str, max_resolution: int = 256,
                 padding_length: Optional[int] = None, cache: bool = True):
        self.h5_files = self._list_scenes(h5_dir)
        self.gt_dir = gt_dir
        self.max_resolution = max_resolution
        shapes = [self._scene_shape(f) for f in self.h5_files]
        sizes = sorted({ps for _, ps in shapes})
        if len(sizes) > 1:
            raise ValueError(f'the scenes of {h5_dir} have texture patches of sizes {sizes}')
        self.texture_patch_size = sizes[0] if sizes else None
        if padding_length is None and shapes:
            padding_length = int(np.ceil(max(n for n, _ in shapes) / BUCKET) * BUCKET)
        self.padding_length = padding_length
        self.cache = cache
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._pool = None  # the decode pool, made on first use, shared by epochs

    # --- the H5 read -------------------------------------------------------
    def _list_scenes(self, h5_dir: str) -> List[str]:
        return list_scene_files(h5_dir)

    def _scene_shape(self, path: str) -> Tuple[int, int]:
        """(triangle count, texture patch size) from the file's metadata."""
        import h5py
        with h5py.File(path, 'r') as h:
            return int(h['triangles'].shape[0]), int(h['texture'].shape[-1])

    def _read_scene(self, path: str) -> Dict[str, np.ndarray]:
        """The scene padded to the bucket, its texture in the file's f16."""
        return load_scene_h5(path, self.padding_length, texture_dtype=np.float16)

    # -----------------------------------------------------------------------
    def __len__(self):
        return len(self.h5_files)

    def _load_item(self, idx: int) -> Dict[str, np.ndarray]:
        h5_file = self.h5_files[idx]
        data = self._read_scene(h5_file)
        base = os.path.splitext(os.path.basename(h5_file))[0]
        gt_path = os.path.join(self.gt_dir, f'{base}.png')
        if os.path.exists(gt_path):
            gt = _load_gt(gt_path, self.max_resolution)
        else:
            gt = np.zeros((self.max_resolution, self.max_resolution, 3), np.float32)
        item = {'triangles': data['triangles'], 'mask': data['mask'], 'vn': data['vn'],
                'c2w': data['c2w'], 'fov': data['fov'][:, None],
                '_gt_single': gt, '_nv': data['c2w'].shape[0]}
        flat = compact_texture(data['texture'])
        if flat is not None:
            item['texture_flat'] = flat
        else:
            item['texture'] = data['texture']
        return item

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.cache:
            item = self._cache.get(idx)
            if item is None:
                item = self._load_item(idx)
                self._cache[idx] = item
        else:
            item = self._load_item(idx)
        out = {k: v for k, v in item.items() if k not in ('_gt_single', '_nv')}
        # one image for every view, read-only and of stride 0; batches()
        # stacks it into a contiguous array
        out['gt'] = np.broadcast_to(item['_gt_single'],
                                    (item['_nv'],) + item['_gt_single'].shape)
        return out

    def split(self, train_frac: float = 0.8, seed: int = 42):
        """A seeded split into (train, validation) index lists."""
        order = np.random.default_rng(seed).permutation(len(self))
        n_train = int(len(self) * train_frac)
        return order[:n_train].tolist(), order[n_train:].tolist()

    def batches(self, indices: Sequence[int], batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True, pad_last: bool = False,
                rank: int = 0, world: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches of ``indices``, shuffled by ``seed`` when
        ``shuffle``.  ``pad_last`` pads a partial last batch to
        ``batch_size`` by cycling its items instead of dropping it, and adds
        ``valid`` ([B] fp32, 1 for a real item, 0 for padding) to every
        batch.  While the cache fills, a pool of two threads decodes the
        epoch's items ahead in the order they are used.

        ``rank``/``world``: every rank shuffles identically (the same seed)
        and yields only items ``rank * per_proc .. (rank + 1) * per_proc`` of
        each global batch (``per_proc = batch_size // world``; ``valid`` is
        sliced the same way)."""
        if batch_size % world:
            raise ValueError(f'global batch_size {batch_size} must divide evenly over '
                             f'{world} processes')
        per_proc = batch_size // world
        indices = list(indices)
        if shuffle:
            np.random.default_rng(seed).shuffle(indices)
        if pad_last:
            drop_last = False
        end = len(indices) - (len(indices) % batch_size if drop_last else 0)

        plan = []
        for start in range(0, max(end, 0), batch_size):
            chunk = indices[start:start + batch_size]
            n_real = len(chunk)
            if pad_last and n_real < batch_size:
                chunk = [chunk[i % n_real] for i in range(batch_size)]
            local = chunk[rank * per_proc:(rank + 1) * per_proc]
            if local:
                plan.append((len(chunk), n_real, local))

        fetched = None
        if self.cache and len(plan) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=2)
            fetched = iter(self._pool.map(self.__getitem__,
                                          [i for _, _, local in plan for i in local]))

        for chunk_len, n_real, local in plan:
            items = ([next(fetched) for _ in local] if fetched is not None
                     else [self[i] for i in local])
            if any('texture_flat' not in it for it in items):
                ps = next(it['texture'].shape[-1] for it in items if 'texture' in it)
                for it in items:
                    if 'texture_flat' in it:
                        it['texture'] = expand_texture_flat(it.pop('texture_flat'), ps)
            out = {k: np.stack([it[k] for it in items]) for k in items[0]}
            if pad_last:
                valid = np.zeros(chunk_len, np.float32)
                valid[:n_real] = 1.0
                out['valid'] = valid[rank * per_proc:(rank + 1) * per_proc]
            yield out

    def close(self) -> None:
        """Shut the decode pool down (a later epoch makes a new one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class InMemoryDataset(RenderFormerDataset):
    """The dataset over scenes held in memory, for a machine without
    ``h5py``: ``scenes`` maps a name to a scene's arrays (``triangles``,
    ``texture``, ``vn``, ``c2w``, ``fov``, as an H5 file holds them), taken
    in the order given; the ground truth of scene ``name`` is
    ``gt_dir/<name>.png``.  Only the H5 read is replaced: the items are the
    H5 dataset's, texture in float16."""

    def __init__(self, scenes: Dict[str, Dict[str, np.ndarray]], gt_dir: str,
                 max_resolution: int = 256, padding_length: Optional[int] = None,
                 cache: bool = True):
        self._scenes = {os.path.join(gt_dir, f'{name}.h5'): sc for name, sc in scenes.items()}
        super().__init__(gt_dir, gt_dir, max_resolution, padding_length, cache)

    def _list_scenes(self, h5_dir: str) -> List[str]:
        return list(self._scenes)

    def _scene_shape(self, path: str) -> Tuple[int, int]:
        sc = self._scenes[path]
        return int(sc['triangles'].shape[0]), int(sc['texture'].shape[-1])

    def _read_scene(self, path: str) -> Dict[str, np.ndarray]:
        return pad_scene(self._scenes[path], self.padding_length, texture_dtype=np.float16)
