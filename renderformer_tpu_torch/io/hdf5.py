"""A reader and writer of HDF5 files in numpy, ``zlib`` and ``struct``.

The port reads and writes its scene files with this module, so that no
entry point needs ``h5py``.  It follows the public *HDF5 File Format
Specification* (version 3) and offers the part of h5py's interface that the
port calls::

    with File(path, 'r') as f:              # or File(path, 'w')
        tex = f['texture'][::16]              # decodes only the chunks it touches
        f['group/name'].attrs['__json__']

``File`` is a ``Group``: ``[]`` with ``/`` paths, ``in``, ``keys()``,
``items()``, ``create_group``, ``create_dataset(name, data,
compression=None | 'gzip', compression_opts=0..9)`` and ``attrs``.  A
``Dataset`` has ``.shape``, ``.dtype``, ``.chunks``, ``.attrs``,
``np.asarray(ds)``, ``ds[()]``, ``ds[:]``, and an int, slice or stepped
slice on axis 0.

The reader reads what h5py 3 writes at its default format bounds: a
version 0 or 1 superblock; version 1 object headers with their
continuation blocks; symbol-table groups (the version 1 B-tree of type 0,
``SNOD`` nodes and the local heap); little-endian integers of 1, 2, 4 and 8
bytes, IEEE half, single and double floats, fixed-length strings,
variable-length strings (the global heap: h5py stores a ``bytes`` scalar so)
and the int8 enum h5py writes for ``bool``; scalar and simple dataspaces;
the version 3 layout message, compact, contiguous or chunked (the version 1
B-tree of type 1, N-d chunks, partial chunks at the edges, each chunk's
filter mask); the deflate, shuffle and fletcher32 filters (the checksum is
checked); and a dataset never written, which reads as its fill value.
Anything else raises a ``ValueError`` that names the structure and the
file: a user block, a version 2 or 3 superblock, version 2 object headers, new-style
groups (link messages, dense storage), a version 4 layout, another filter,
a big-endian or compound type.

The writer writes a version 0 superblock, version 1 object headers and
symbol-table groups.  ``compression='gzip'`` makes a chunked dataset
through deflate at the given level, chunks of whole rows on axis 0 of
about 1 MiB (``CHUNK_BYTES``) each, so that a strided row read decodes one
chunk a sampled row; without compression a dataset is contiguous.  Data
and attributes are held in memory until the file is closed, then written
in one pass.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEFINED = 0xFFFFFFFFFFFFFFFF
CHUNK_BYTES = 1 << 20        # the writer's chunk: whole rows, about this many bytes
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32   # the version 0 superblock's B-tree K values
_HEAP_FREE_NULL = 1          # a local heap's free list with no block

# header messages
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x06, 0x07, 0x08, 0x0A, 0x0B, 0x0C
_COMMENT, _MTIME_OLD, _CONTINUATION, _SYMBOL_TABLE, _MTIME = 0x0D, 0x0E, 0x10, 0x11, 0x12
_ATTR_INFO, _REFCOUNT = 0x15, 0x16
_IGNORED = {_NIL, _COMMENT, _MTIME_OLD, _MTIME, _REFCOUNT}
# filters
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3

# the datatype message of each IEEE float width: (sign bit, exponent location
# and size, mantissa location and size, exponent bias)
_FLOATS = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
           8: (63, 52, 11, 0, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

class _Dtype:
    """A decoded datatype: its numpy dtype, and whether its elements are
    variable-length strings (16-byte global-heap references on disk)."""

    def __init__(self, dtype: np.dtype, vlen: bool = False, utf8: bool = False):
        self.dtype, self.vlen, self.utf8 = dtype, vlen, utf8

    @property
    def itemsize(self) -> int:
        return 16 if self.vlen else self.dtype.itemsize


class _Reader:
    """The open file: a read-only map of it and the decoders of its
    structures.  Every structure is read at its address on demand."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, 'rb')
        try:
            size = os.fstat(self._file.fileno()).st_size
            if size < len(SIGNATURE):
                self.fail(f'a file of {size} bytes')
            self.mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except BaseException:
            self._file.close()
            raise
        self._heaps: Dict[int, bytes] = {}
        try:
            self._superblock()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.mm is not None:
            self.mm.close()
            self.mm = None
        self._file.close()

    def fail(self, what: str):
        raise ValueError(f'{self.path}: {what} is outside what this HDF5 reader reads '
                         f'(h5py 3 at its default format bounds)')

    # --- primitives --------------------------------------------------------
    def u(self, at: int, n: int) -> int:
        if at < 0 or at + n > len(self.mm):
            raise ValueError(f'{self.path}: a read of {n} bytes at {at} past the end of the '
                             f'file ({len(self.mm)} bytes): the file is truncated or corrupt')
        return int.from_bytes(self.mm[at:at + n], 'little')

    def raw(self, at: int, n: int) -> bytes:
        if at < 0 or at + n > len(self.mm):
            raise ValueError(f'{self.path}: {n} bytes at {at} lie past the end of the file '
                             f'({len(self.mm)} bytes): the file is truncated or corrupt')
        return self.mm[at:at + n]

    def addr(self, at: int) -> int:
        a = self.u(at, self.so)
        return UNDEFINED if a == (1 << (8 * self.so)) - 1 else a + self.base

    def length(self, at: int) -> int:
        return self.u(at, self.sl)

    # --- the superblock -----------------------------------------------------
    def _superblock(self) -> None:
        at = 0
        if self.mm[at:at + 8] != SIGNATURE:
            raise ValueError(f'{self.path}: no HDF5 signature at offset 0: not an HDF5 file '
                             f'(or one with a user block, which this reader does not read)')
        version = self.mm[at + 8]
        if version not in (0, 1):
            self.fail(f'superblock version {version}')
        self.so, self.sl = self.mm[at + 13], self.mm[at + 14]
        if (self.so, self.sl) != (8, 8):
            self.fail(f'sizes of offsets {self.so} and lengths {self.sl}')
        # the B-trees' K values (at + 16, and at + 24 in version 1) bound a
        # node's size, not what the reader needs: each node counts its entries
        p = at + (28 if version == 1 else 24)
        self.base = 0
        self.base = self.addr(p)
        p += 4 * self.so
        # the root group's symbol table entry: its object header's address
        self.root = self.addr(p + self.so)

    # --- object headers -----------------------------------------------------
    def messages(self, at: int) -> List[Tuple[int, int, int, int]]:
        """(type, flags, data address, size) of every message of the object
        header at ``at``, continuation blocks followed."""
        if self.raw(at, 4) == b'OHDR':
            self.fail(f'a version 2 object header (at {at})')
        version = self.mm[at]
        if version != 1:
            self.fail(f'object header version {version} (at {at})')
        count, size = self.u(at + 2, 2), self.u(at + 8, 4)
        blocks, out = [(at + 16, size)], []
        while blocks:
            start, n = blocks.pop(0)
            p, end = start, start + n
            while p + 8 <= end:
                mtype, msize, flags = self.u(p, 2), self.u(p + 2, 2), self.mm[p + 4]
                if p + 8 + msize > end:
                    raise ValueError(f'{self.path}: a header message at {p} runs past its '
                                     f'block: the file is corrupt')
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(p + 8), self.length(p + 8 + self.so)))
                elif mtype != _NIL:
                    if flags & 0x02:
                        self.fail(f'a shared header message (type {mtype:#x} at {p})')
                    out.append((mtype, flags, p + 8, msize))
                p += 8 + msize
        if len(out) > count:
            raise ValueError(f'{self.path}: the object header at {at} holds more messages '
                             f'than its count {count}: the file is corrupt')
        return out

    def node(self, at: int):
        """The Group or Dataset whose object header is at ``at``."""
        msgs = self.messages(at)
        types = {m[0] for m in msgs}
        for t, what in ((_LINK, 'a link message (a new-style group)'),
                        (_LINK_INFO, 'a link info message (a new-style group)'),
                        (_GROUP_INFO, 'a group info message (a new-style group)'),
                        (_ATTR_INFO, 'an attribute info message (dense attribute storage)'),
                        (_EXTERNAL, 'an external data files message')):
            if t in types:
                self.fail(f'{what} in the object header at {at}')
        known = {_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT, _FILTERS, _ATTRIBUTE,
                 _SYMBOL_TABLE} | _IGNORED
        unknown = sorted(types - known)
        if unknown:
            self.fail(f'header message type {unknown[0]:#x} in the object header at {at}')
        attrs = [(p, n) for t, _, p, n in msgs if t == _ATTRIBUTE]
        if _SYMBOL_TABLE in types:
            p = next(p for t, _, p, _ in msgs if t == _SYMBOL_TABLE)
            return Group(_reader=self, _entries=self.group_entries(self.addr(p),
                                                                   self.addr(p + self.so)),
                         _attrs=attrs)
        if _LAYOUT in types and _DATASPACE in types and _DATATYPE in types:
            return Dataset(_reader=self, _header={t: (p, n) for t, _, p, n in msgs}, _attrs=attrs)
        self.fail(f'an object with neither a symbol table nor a layout (at {at})')

    # --- groups -------------------------------------------------------------
    def heap(self, at: int) -> bytes:
        """The data segment of the local heap at ``at``."""
        if at not in self._heaps:
            if self.raw(at, 4) != b'HEAP':
                raise ValueError(f'{self.path}: no local heap at {at}: the file is corrupt')
            size = self.length(at + 8)
            self._heaps[at] = self.raw(self.addr(at + 8 + 2 * self.sl), size)
        return self._heaps[at]

    def heap_name(self, heap: bytes, offset: int) -> str:
        end = heap.find(b'\0', offset)
        if end < 0:
            raise ValueError(f'{self.path}: a name at heap offset {offset} has no end')
        return heap[offset:end].decode('utf-8')

    def btree(self, at: int, node_type: int, key_size: int) -> Iterator[Tuple[int, int]]:
        """(key address, child address) of each leaf entry of the version 1
        B-tree at ``at``, in key order; the key is the one left of the
        child."""
        if self.raw(at, 4) != b'TREE':
            raise ValueError(f'{self.path}: no B-tree node at {at}: the file is corrupt')
        if self.mm[at + 4] != node_type:
            raise ValueError(f'{self.path}: a B-tree node of type {self.mm[at + 4]} at {at} '
                             f'where type {node_type} belongs: the file is corrupt')
        level, used = self.mm[at + 5], self.u(at + 6, 2)
        p = at + 8 + 2 * self.so
        for i in range(used):
            key = p + i * (key_size + self.so)
            child = self.addr(key + key_size)
            if level:
                yield from self.btree(child, node_type, key_size)
            else:
                yield key, child

    def group_entries(self, btree: int, heap_at: int) -> Dict[str, int]:
        """name -> object header address of a symbol-table group, in the
        B-tree's (name) order."""
        heap, out = self.heap(heap_at), {}
        entry = 2 * self.so + 24
        for _, snod in self.btree(btree, 0, self.sl):
            if self.raw(snod, 4) != b'SNOD':
                raise ValueError(f'{self.path}: no symbol table node at {snod}: the file is '
                                 f'corrupt')
            for i in range(self.u(snod + 6, 2)):
                e = snod + 8 + i * entry
                out[self.heap_name(heap, self.length(e))] = self.addr(e + self.so)
        return out

    # --- datatypes and dataspaces ---------------------------------------------
    def datatype(self, at: int) -> Tuple[_Dtype, int]:
        """The datatype message at ``at``: (decoded type, bytes it takes)."""
        cls, version = self.mm[at] & 0x0F, self.mm[at] >> 4
        bits = self.u(at + 1, 3)
        size = self.u(at + 4, 4)
        if cls == 0:
            signed = bool(bits & 0x08)
            if bits & 0x01:
                self.fail('a big-endian integer type')
            if size not in (1, 2, 4, 8) or self.u(at + 8, 2) or self.u(at + 10, 2) != 8 * size:
                self.fail(f'an integer type of {size} bytes at bit offset '
                          f'{self.u(at + 8, 2)}, precision {self.u(at + 10, 2)}')
            return _Dtype(np.dtype(f'<{"i" if signed else "u"}{size}')), 12
        if cls == 1:
            if bits & 0x41:
                self.fail('a big-endian or VAX float type')
            layout = (self.u(at + 2, 1), self.mm[at + 12], self.mm[at + 13], self.mm[at + 14],
                      self.mm[at + 15], self.u(at + 16, 4))
            if size not in _FLOATS or layout != _FLOATS[size] or self.u(at + 8, 2) \
                    or self.u(at + 10, 2) != 8 * size:
                self.fail(f'a float type of {size} bytes that is not IEEE')
            return _Dtype(np.dtype(f'<f{size}')), 20
        if cls == 3:
            return _Dtype(np.dtype(f'S{size}')), 8
        if cls == 8:
            base, n = self.datatype(at + 8)
            members = bits & 0xFFFF
            p, names = at + 8 + n, []
            for _ in range(members):
                end = self.mm.find(b'\0', p)
                names.append(self.raw(p, end - p).decode())
                p = p + _pad8(end - p + 1) if version < 3 else end + 1
            values = np.frombuffer(self.raw(p, members * base.itemsize), base.dtype)
            p += members * base.itemsize
            if base.dtype == np.int8 and dict(zip(names, values.tolist())) == {'FALSE': 0,
                                                                              'TRUE': 1}:
                return _Dtype(np.dtype(np.bool_)), p - at
            return base, p - at
        if cls == 9:
            kind, charset = bits & 0x0F, (bits >> 8) & 0x0F
            if kind != 1:
                self.fail('a variable-length sequence type')
            base, n = self.datatype(at + 8)
            return _Dtype(np.dtype(object), vlen=True, utf8=charset == 1), 8 + n
        names = {2: 'time', 4: 'bitfield', 5: 'opaque', 6: 'compound', 7: 'reference',
                 10: 'array'}
        self.fail(f'the {names.get(cls, f"class {cls}")} datatype')

    def dataspace(self, at: int) -> Tuple[int, ...]:
        """The shape of the dataspace message at ``at``."""
        version, rank, flags = self.mm[at], self.mm[at + 1], self.mm[at + 2]
        if version == 1:
            p = at + 8
        elif version == 2:
            if self.mm[at + 3] == 2:
                self.fail('a null dataspace')
            p = at + 4
        else:
            self.fail(f'dataspace message version {version}')
        if flags & 0x02:
            self.fail('a dataspace with a permutation index')
        return tuple(self.length(p + i * self.sl) for i in range(rank))

    def vlen_strings(self, refs: bytes, count: int, utf8: bool, as_str: bool) -> List:
        """The ``count`` variable-length strings whose 16-byte global heap
        references are ``refs``."""
        out = []
        for i in range(count):
            r = refs[i * (8 + self.so):]
            n = int.from_bytes(r[:4], 'little')
            coll = int.from_bytes(r[4:4 + self.so], 'little')
            index = int.from_bytes(r[4 + self.so:8 + self.so], 'little')
            data = self.global_object(coll, index)[:n] if coll else b''
            out.append(data.decode('utf-8' if utf8 else 'ascii') if as_str else data)
        return out

    def global_object(self, coll: int, index: int) -> bytes:
        if self.raw(coll, 4) != b'GCOL':
            raise ValueError(f'{self.path}: no global heap collection at {coll}')
        end = coll + self.length(coll + 8)
        p = coll + 8 + self.sl
        while p + 8 + self.sl <= end:
            i, size = self.u(p, 2), self.length(p + 8)
            if i == 0:
                break
            if i == index:
                return self.raw(p + 8 + self.sl, size)
            p += 8 + self.sl + _pad8(size)
        raise ValueError(f'{self.path}: object {index} missing from the global heap at {coll}')

    def attribute(self, at: int):
        """(name, value) of the attribute message at ``at``; a scalar reads
        as a numpy scalar (str for a variable-length string, as h5py)."""
        version = self.mm[at]
        if version not in (1, 2, 3):
            self.fail(f'attribute message version {version}')
        name_n, type_n, space_n = self.u(at + 2, 2), self.u(at + 4, 2), self.u(at + 6, 2)
        p = at + (9 if version == 3 else 8)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = self.raw(p, name_n).rstrip(b'\0').decode('utf-8')
        p += pad(name_n)
        dt, _ = self.datatype(p)
        p += pad(type_n)
        shape = self.dataspace(p)
        p += pad(space_n)
        count = int(np.prod(shape, dtype=np.int64))
        data = self.raw(p, count * dt.itemsize)
        if dt.vlen:
            value = np.empty(count, object)
            value[:] = self.vlen_strings(data, count, dt.utf8, as_str=True)
            value = value.reshape(shape)
        else:
            value = np.frombuffer(data, dt.dtype).reshape(shape).copy()
        return name, value[()] if shape == () else value


class _Attrs:
    """A node's attributes: a mapping of name to numpy value.  Read from
    the file on first use, or held for the writer."""

    def __init__(self, reader: Optional[_Reader] = None, messages=()):
        self._reader, self._messages, self._items = reader, list(messages), None

    def _all(self) -> Dict[str, object]:
        if self._items is None:
            self._items = dict(self._reader.attribute(p) for p, _ in self._messages)
        return self._items

    def __getitem__(self, name: str):
        return self._all()[name]

    def __setitem__(self, name: str, value) -> None:
        if self._reader is not None:
            raise ValueError('attributes of a file opened for reading are read-only')
        self._all()[name] = np.asarray(value)

    def __contains__(self, name: str) -> bool:
        return name in self._all()

    def __iter__(self):
        return iter(self._all())

    def __len__(self) -> int:
        return len(self._all())

    def get(self, name: str, default=None):
        return self._all().get(name, default)

    def keys(self):
        return self._all().keys()

    def items(self):
        return self._all().items()


class Dataset:
    """An array of the file: read on access (only the chunks a selection
    touches), or held in memory until its file is written."""

    def __init__(self, data: Optional[np.ndarray] = None, compression: Optional[str] = None,
                 level: int = 4, _reader: Optional[_Reader] = None, _header=None, _attrs=()):
        self._reader = _reader
        self.attrs = _Attrs(_reader, _attrs) if _reader else _Attrs()
        self.decoded = 0   # chunks decoded by this object's reads
        if _reader is None:
            self._data, self.compression, self.level = data, compression, level
            self.shape, self.dtype = data.shape, data.dtype
            self.chunks = _chunk_shape(data) if compression else None
            return
        r = _reader
        self.shape = r.dataspace(_header[_DATASPACE][0])
        self._type, _ = r.datatype(_header[_DATATYPE][0])
        self.dtype = self._type.dtype
        self._fill = self._fill_value(_header)
        self._filters = self._pipeline(_header[_FILTERS][0]) if _FILTERS in _header else []
        self._layout(_header[_LAYOUT][0])

    # --- the header ---------------------------------------------------------
    def _fill_value(self, header) -> Optional[bytes]:
        r = self._reader
        if _FILL in header:
            at = header[_FILL][0]
            version = r.mm[at]
            if version in (1, 2):
                defined = version == 1 or r.mm[at + 3]
                p = at + 4
            elif version == 3:
                defined = r.mm[at + 1] & 0x20
                p = at + 2
            else:
                r.fail(f'fill value message version {version}')
            if defined:
                n = r.u(p, 4)
                return r.raw(p + 4, n) if n else None
            return None
        if _FILL_OLD in header:
            at = header[_FILL_OLD][0]
            n = r.u(at, 4)
            return r.raw(at + 4, n) if n else None
        return None

    def _pipeline(self, at: int) -> List[Tuple[int, Tuple[int, ...]]]:
        """(filter id, client data) of each filter in the order of writing."""
        r = self._reader
        version, n = r.mm[at], r.mm[at + 1]
        if version not in (1, 2):
            r.fail(f'filter pipeline message version {version}')
        p, out = at + (8 if version == 1 else 2), []
        for _ in range(n):
            fid = r.u(p, 2)
            name_n = r.u(p + 2, 2) if version == 1 or fid >= 256 else 0
            q = p + (8 if version == 1 or fid >= 256 else 6)
            ncd = r.u(q - 2, 2)
            q += _pad8(name_n) if version == 1 else name_n
            cd = tuple(r.u(q + 4 * i, 4) for i in range(ncd))
            q += 4 * ncd
            if version == 1 and ncd % 2:
                q += 4
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                r.fail(f'filter {fid}' + (f' ({r.raw(p + 8, name_n).rstrip(bytes(1)).decode()})'
                                          if name_n and version == 1 else ''))
            out.append((fid, cd))
            p = q
        return out

    def _layout(self, at: int) -> None:
        r = self._reader
        version, cls = r.mm[at], r.mm[at + 1]
        if version != 3:
            r.fail(f'layout message version {version}')
        self.chunks, self._compact, self._address = None, None, UNDEFINED
        if cls == 0:
            n = r.u(at + 2, 2)
            self._compact = r.raw(at + 4, n)
        elif cls == 1:
            self._address = r.addr(at + 2)
        elif cls == 2:
            ndims = r.mm[at + 2]
            self._address = r.addr(at + 3)
            dims = [r.u(at + 3 + r.so + 4 * i, 4) for i in range(ndims)]
            if ndims != len(self.shape) + 1:
                raise ValueError(f'{r.path}: chunks of rank {ndims - 1} in a dataset of rank '
                                 f'{len(self.shape)}: the file is corrupt')
            self.chunks = tuple(dims[:-1])
        else:
            r.fail(f'layout class {cls}')
        if self._filters and self.chunks is None:
            raise ValueError(f'{r.path}: filters on a dataset that is not chunked')

    # --- reads ----------------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        out = self[()]
        out = np.asarray(out) if dtype is None else np.asarray(out, dtype=dtype)
        return out

    def __getitem__(self, key):
        if isinstance(key, tuple) and not key:
            rows = None
        elif not self.shape:
            raise ValueError('a scalar dataset takes only [()]')
        elif isinstance(key, (int, np.integer)):
            i = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f'index {int(key)} out of range for axis 0 of size '
                                 f'{self.shape[0]}')
            return self._rows(range(i, i + 1))[0]
        elif isinstance(key, slice):
            rows = range(*key.indices(self.shape[0]))
            if rows.step < 0:
                raise ValueError('a negative step is not supported')
        else:
            raise TypeError(f'selection {key!r}: an int or a slice on axis 0, or ()')
        out = self._rows(rows)
        return out[()] if not self.shape else out

    def _rows(self, rows: Optional[range]) -> np.ndarray:
        """The rows of axis 0 in ``rows`` (every row where None)."""
        if self._reader is None:
            data = self._data
            return data.copy() if rows is None else data[rows.start:rows.stop:rows.step].copy()
        if self._reader.mm is None:
            raise ValueError('the file of this dataset is closed')
        if rows is None:
            rows = range(self.shape[0]) if self.shape else None
        if self.chunks is not None:
            return self._chunked(rows)
        r, t = self._reader, self._type
        n = int(np.prod(self.shape, dtype=np.int64))
        if self._compact is not None:
            raw = self._compact
        elif self._address == UNDEFINED:
            raw = None
        else:
            raw = r.raw(self._address, n * t.itemsize)
        full = self._decode(raw, n).reshape(self.shape)
        return full if rows is None else full[rows.start:rows.stop:rows.step]

    def _decode(self, raw: Optional[bytes], n: int) -> np.ndarray:
        """``n`` elements from their bytes on disk (the fill value where
        ``raw`` is None)."""
        t = self._type
        if raw is None:
            return self._filled(n)
        if t.vlen:
            out = np.empty(n, object)
            out[:] = self._reader.vlen_strings(raw, n, t.utf8, as_str=False)
            return out
        return np.frombuffer(raw, t.dtype, count=n).copy()

    def _filled(self, n: int) -> np.ndarray:
        t = self._type
        if t.vlen:
            out = np.empty(n, object)
            out[:] = b''
            return out
        if self._fill is None:
            return np.zeros(n, t.dtype)
        return np.repeat(np.frombuffer(self._fill, t.dtype, count=1), n)

    def _chunk_index(self) -> List[Tuple[Tuple[int, ...], int, int, int]]:
        """(origin, stored size, filter mask, address) of every stored chunk."""
        if self._address == UNDEFINED:
            return []
        r = self._reader
        ndims = len(self.shape) + 1
        out = []
        for key, child in r.btree(self._address, 1, 8 + 8 * ndims):
            origin = tuple(r.u(key + 8 + 8 * i, 8) for i in range(ndims - 1))
            out.append((origin, r.u(key, 4), r.u(key + 4, 4), child))
        return out

    def _chunked(self, rows: Optional[range]) -> np.ndarray:
        """The rows in ``rows`` of a chunked dataset, decoding only the
        chunks that hold one of them."""
        shape, chunks = self.shape, self.chunks
        if rows is None:
            raise ValueError(f'{self._reader.path}: a chunked scalar dataset: the file is '
                             f'corrupt')
        index = self._chunk_index()
        n = len(rows)
        grid = int(np.prod([-(-s // c) for s, c in zip(shape, chunks)], dtype=np.int64))
        out_shape = (n,) + tuple(shape[1:])
        if len(index) < grid:   # a chunk never written reads as the fill value
            out = self._filled(int(np.prod(out_shape, dtype=np.int64))).reshape(out_shape)
        else:
            out = np.empty(out_shape, object if self._type.vlen else self.dtype)
        per_chunk = int(np.prod(chunks, dtype=np.int64))
        for origin, nbytes, mask, at in index:
            lo, hi = origin[0], origin[0] + chunks[0]
            # the selected rows in [lo, hi): positions k0..k1-1 of ``rows``
            k0 = max(0, -(-(lo - rows.start) // rows.step))
            k1 = min(n, -(-(hi - rows.start) // rows.step))
            if k0 >= k1:
                continue
            data = self._decode(self._unfilter(self._reader.raw(at, nbytes), mask),
                                per_chunk).reshape(chunks)
            self.decoded += 1
            first = rows.start + k0 * rows.step - lo
            src = slice(first, first + (k1 - k0 - 1) * rows.step + 1, rows.step)
            inner = tuple(slice(0, min(c, s - o)) for o, c, s in zip(origin[1:], chunks[1:],
                                                                       shape[1:]))
            dest = tuple(slice(o, o + sl.stop) for o, sl in zip(origin[1:], inner))
            out[(slice(k0, k1),) + dest] = data[(src,) + inner]
        return out

    def _unfilter(self, raw: bytes, mask: int) -> bytes:
        """A chunk's bytes through its filters, last first; a filter whose
        bit is set in ``mask`` was skipped when the chunk was written."""
        for i in reversed(range(len(self._filters))):
            fid, cd = self._filters[i]
            if mask & (1 << i):
                continue
            if fid == _DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == _SHUFFLE:
                raw = _unshuffle(raw, cd[0] if cd else self._type.itemsize)
            else:
                want = int.from_bytes(raw[-4:], 'little')
                raw = raw[:-4]
                got = fletcher32(raw)
                if want != got:
                    raise ValueError(f'{self._reader.path}: a chunk fails its fletcher32 '
                                     f'checksum ({want:#010x} stored, {got:#010x} read)')
        return raw


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n).T.tobytes()
    return body + data[n * size:]


def fletcher32(data: bytes) -> int:
    """The HDF5 library's Fletcher-32 checksum (``H5_checksum_fletcher32``):
    16-bit big-endian words, sums folded every 360 words."""
    n = len(data) // 2
    words = np.frombuffer(data, '>u2', count=n).astype(np.uint64)
    sum1 = sum2 = 0
    for start in range(0, n, 360):
        w = words[start:start + 360]
        t = len(w)
        sum2 += t * sum1 + int(np.dot(np.arange(t, 0, -1, dtype=np.uint64), w))
        sum1 += int(w.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


class Group:
    """A group: read from the file on access, or held for the writer."""

    def __init__(self, _reader: Optional[_Reader] = None, _entries=None, _attrs=()):
        self._reader = _reader
        self._entries: Dict[str, int] = dict(_entries or {})   # name -> header address
        self._children: Dict[str, object] = {}
        self.attrs = _Attrs(_reader, _attrs) if _reader else _Attrs()

    def _names(self) -> List[str]:
        if self._reader is not None:
            return list(self._entries)
        return sorted(self._children, key=lambda s: s.encode())

    def _child(self, name: str):
        if name not in self._children:
            if self._reader is None or name not in self._entries:
                raise KeyError(f'{name!r} is not in this group')
            if self._reader.mm is None:
                raise ValueError('the file of this group is closed')
            self._children[name] = self._reader.node(self._entries[name])
        return self._children[name]

    def __getitem__(self, path: str):
        node = self
        for part in (p for p in path.split('/') if p):
            if not isinstance(node, Group):
                raise KeyError(f'{path!r}: a dataset has no members')
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __iter__(self):
        return iter(self._names())

    def __len__(self) -> int:
        return len(self._names())

    def keys(self) -> List[str]:
        return self._names()

    def items(self) -> list:
        return [(n, self._child(n)) for n in self._names()]

    # --- the writer -----------------------------------------------------------
    def _parent_of(self, path: str) -> Tuple['Group', str]:
        if self._reader is not None:
            raise ValueError('a file opened for reading cannot be written')
        parts = [p for p in path.split('/') if p]
        if not parts:
            raise ValueError(f'name {path!r}: empty')
        node = self
        for part in parts[:-1]:
            if part not in node._children:
                node._children[part] = Group()
            node = node._children[part]
            if not isinstance(node, Group):
                raise ValueError(f'{path!r}: {part!r} is a dataset')
        if parts[-1] in node._children:
            raise ValueError(f'{path!r} already exists')
        return node, parts[-1]

    def create_group(self, path: str) -> 'Group':
        node, name = self._parent_of(path)
        node._children[name] = Group()
        return node._children[name]

    def create_dataset(self, path: str, data, compression: Optional[str] = None,
                       compression_opts: Optional[int] = None) -> Dataset:
        node, name = self._parent_of(path)
        arr = np.array(data)   # a copy: later writes to ``data`` do not reach the file
        _type_message(arr.dtype)   # refuse a dtype the writer cannot encode now, not at close
        if compression not in (None, 'gzip'):
            raise ValueError(f'compression {compression!r}: None or "gzip"')
        level = 4 if compression_opts is None else int(compression_opts)
        if compression and not 0 <= level <= 9:
            raise ValueError(f'compression_opts {level}: a gzip level 0-9')
        if compression and arr.ndim == 0:
            raise ValueError(f'{path!r}: a scalar dataset cannot be compressed')
        node._children[name] = Dataset(arr, compression, level)
        return node._children[name]

    def __setitem__(self, path: str, data) -> None:
        self.create_dataset(path, data)


class File(Group):
    """``File(path, 'r')`` reads a file; ``File(path, 'w')`` makes a new one,
    written when it is closed (at the end of its ``with`` block)."""

    def __init__(self, path, mode: str = 'r'):
        self.path = os.fspath(path)
        if mode == 'r':
            reader = _Reader(self.path)
            try:
                root = reader.node(reader.root)
            except BaseException:
                reader.close()
                raise
            if not isinstance(root, Group):
                reader.close()
                raise ValueError(f'{self.path}: the root object is not a group')
            super().__init__(reader, root._entries, root.attrs._messages)
        elif mode == 'w':
            super().__init__()
        else:
            raise ValueError(f"mode {mode!r}: 'r' to read a file or 'w' to write a new one")
        self._open = True

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        if self._reader is not None:
            self._reader.close()
        else:
            _write_file(self.path, self)

    def __enter__(self) -> 'File':
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self._reader is None:
            self._open = False   # a write that failed part-way leaves no file
            return
        self.close()


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _chunk_shape(arr: np.ndarray) -> Tuple[int, ...]:
    """Whole rows of axis 0, about CHUNK_BYTES a chunk."""
    row = max(1, int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.dtype.itemsize)
    rows = max(1, min(arr.shape[0], CHUNK_BYTES // row))
    return (rows,) + tuple(max(1, s) for s in arr.shape[1:])


def _type_message(dtype: np.dtype) -> bytes:
    """The version 1 datatype message of a numpy dtype."""
    if dtype == np.bool_:
        base = _type_message(np.dtype(np.int8))
        names = b''.join(n + bytes(_pad8(len(n) + 1) - len(n)) for n in (b'FALSE', b'TRUE'))
        return struct.pack('<B3sI', 0x18, (2).to_bytes(3, 'little'), 1) + base + names + b'\0\1'
    if dtype.kind in 'iu' and dtype.itemsize in (1, 2, 4, 8) and dtype.byteorder != '>':
        bits = 0x08 if dtype.kind == 'i' else 0
        return struct.pack('<B3sIHH', 0x10, bits.to_bytes(3, 'little'), dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == 'f' and dtype.itemsize in _FLOATS and dtype.byteorder != '>':
        sign, eloc, esize, mloc, msize, bias = _FLOATS[dtype.itemsize]
        bits = 0x20 | (sign << 8)
        return struct.pack('<B3sIHHBBBBI', 0x11, bits.to_bytes(3, 'little'), dtype.itemsize, 0,
                           8 * dtype.itemsize, eloc, esize, mloc, msize, bias)
    if dtype.kind == 'S' and dtype.itemsize > 0:
        return struct.pack('<B3sI', 0x13, (1).to_bytes(3, 'little'), dtype.itemsize)   # null-padded
    raise ValueError(f'dtype {dtype}: the writer takes bool, little-endian integers of 1-8 '
                     f'bytes, IEEE floats of 2, 4 or 8 bytes and fixed-length bytes')


def _space_message(shape: Tuple[int, ...]) -> bytes:
    """Version 1 dataspace: the dimensions, and as maximum the same."""
    flags = 1 if shape else 0
    dims = b''.join(struct.pack('<Q', s) for s in shape)
    return struct.pack('<BBBB4x', 1, len(shape), flags, 0) + dims + (dims if shape else b'')


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + bytes(_pad8(len(body)) - len(body))
    return struct.pack('<HHB3x', mtype, len(body), flags) + body


def _attribute_message(name: str, value: np.ndarray) -> bytes:
    value = np.asarray(value)
    nm = name.encode('utf-8') + b'\0'
    dt, sp = _type_message(value.dtype), _space_message(value.shape)
    data = np.asarray(value, dtype=value.dtype.newbyteorder('<'), order='C').tobytes()
    body = (struct.pack('<BBHHH', 1, 0, len(nm), len(dt), len(sp))
            + nm + bytes(_pad8(len(nm)) - len(nm)) + dt + bytes(_pad8(len(dt)) - len(dt))
            + sp + bytes(_pad8(len(sp)) - len(sp)) + data)
    return _message(_ATTRIBUTE, body)


class _Out:
    """The file's bytes as they are laid out: every structure appended at
    an 8-byte boundary."""

    def __init__(self):
        self.buf = bytearray()

    def put(self, data: bytes) -> int:
        self.buf += bytes(_pad8(len(self.buf)) - len(self.buf))
        at = len(self.buf)
        self.buf += data
        return at

    def header(self, messages: List[bytes]) -> int:
        body = b''.join(messages)
        return self.put(struct.pack('<BBHII4x', 1, 0, len(messages), 1, len(body)) + body)

    def btree(self, node_type: int, two_k: int, key_size: int,
              entries: List[Tuple[bytes, int]], last_key: bytes) -> int:
        """A version 1 B-tree over ``entries`` ((key left of the child, child
        address), in order) with ``last_key`` right of the last; every node
        allocated at its full size of 2K children.  Returns the root's
        address."""
        level = 0
        while True:
            nodes = []
            for s in range(0, max(1, len(entries)), two_k):
                part = entries[s:s + two_k]
                right = entries[s + two_k][0] if s + two_k < len(entries) else last_key
                body = b''.join(k + struct.pack('<Q', c) for k, c in part) + right
                size = 24 + two_k * 8 + (two_k + 1) * key_size
                node = (struct.pack('<4sBBHQQ', b'TREE', node_type, level, len(part), UNDEFINED,
                                    UNDEFINED) + body)
                nodes.append((part[0][0] if part else right,
                              self.put(node + bytes(size - len(node)))))
            if len(nodes) == 1:
                return nodes[0][1]
            entries, level = nodes, level + 1

    def dataset(self, ds: Dataset) -> int:
        arr = np.asarray(ds._data, dtype=ds._data.dtype.newbyteorder('<'), order='C')
        msgs = [_message(_DATASPACE, _space_message(arr.shape)),
                _message(_DATATYPE, _type_message(arr.dtype), flags=1)]
        if ds.compression is None:
            addr = self.put(arr.tobytes()) if arr.nbytes else UNDEFINED
            msgs += [_message(_FILL, bytes([2, 2, 2, 1]) + struct.pack('<I', 0), flags=1),
                     _message(_LAYOUT, struct.pack('<BBQQ', 3, 1, addr, arr.nbytes))]
        else:
            chunks = ds.chunks
            addr = self._chunked(arr, chunks, ds.level)
            dims = chunks + (arr.dtype.itemsize,)
            filters = (struct.pack('<BB6x', 1, 1) + struct.pack('<HHHH', _DEFLATE, 8, 1, 1)
                       + b'deflate\0' + struct.pack('<I4x', ds.level))
            msgs += [_message(_FILL, bytes([2, 3, 2, 1]) + struct.pack('<I', 0), flags=1),
                     _message(_FILTERS, filters, flags=1),
                     _message(_LAYOUT, struct.pack('<BBBQ', 3, 2, len(dims), addr)
                              + b''.join(struct.pack('<I', d) for d in dims))]
        msgs += [_attribute_message(k, v) for k, v in ds.attrs.items()]
        return self.header(msgs)

    def _chunked(self, arr: np.ndarray, chunks: Tuple[int, ...], level: int) -> int:
        if arr.size == 0:
            return UNDEFINED
        rows = chunks[0]
        pieces = [arr[s:s + rows] for s in range(0, arr.shape[0], rows)]

        def encode(piece: np.ndarray) -> bytes:
            if piece.shape[0] < rows:   # the edge chunk is stored at its full size
                piece = np.concatenate([piece, np.zeros((rows - piece.shape[0],)
                                                        + piece.shape[1:], piece.dtype)])
            return zlib.compress(piece.tobytes(), level)

        if len(pieces) > 1:   # zlib releases the interpreter lock
            with ThreadPoolExecutor(min(len(pieces), os.cpu_count() or 1, 8)) as pool:
                blobs = list(pool.map(encode, pieces))
        else:
            blobs = [encode(pieces[0])]
        ndims = arr.ndim + 1
        entries = []
        for i, blob in enumerate(blobs):
            at = self.put(blob)
            origin = (i * rows,) + (0,) * (ndims - 1)
            entries.append((struct.pack(f'<II{ndims}Q', len(blob), 0, *origin), at))
        end = (len(blobs) * rows,) + tuple(chunks[1:]) + (arr.dtype.itemsize,)
        return self.btree(1, 2 * _CHUNK_K, 8 + 8 * ndims, entries,
                          struct.pack(f'<II{ndims}Q', 0, 0, *end))

    def group(self, group: Group) -> Tuple[int, int, int]:
        """Writes a group's members, then the group; returns (object header,
        B-tree, local heap) addresses."""
        names = group._names()
        headers = [self.group(c)[0] if isinstance(c, Group) else self.dataset(c)
                   for c in (group._children[n] for n in names)]
        heap, offsets = bytearray(8), []   # offset 0: the empty name
        for n in names:
            offsets.append(len(heap))
            raw = n.encode('utf-8') + b'\0'
            heap += raw + bytes(_pad8(len(raw)) - len(raw))
        data_at = self.put(bytes(heap))
        heap_at = self.put(struct.pack('<4sB3xQQQ', b'HEAP', 0, len(heap), _HEAP_FREE_NULL,
                                       data_at))
        snods = []
        for s in range(0, len(names), 2 * _LEAF_K):
            part = range(s, min(s + 2 * _LEAF_K, len(names)))
            body = b''.join(struct.pack('<QQI4x16x', offsets[i], headers[i], 0) for i in part)
            node = struct.pack('<4sBxH', b'SNOD', 1, len(part)) + body
            snods.append((offsets[part[-1]], self.put(node + bytes(8 + 2 * _LEAF_K * 40
                                                                   - len(node)))))
        # a key is the heap offset of the greatest name left of it; the first the empty name
        keys = [0] + [k for k, _ in snods]
        entries = [(struct.pack('<Q', keys[i]), at) for i, (_, at) in enumerate(snods)]
        btree = self.btree(0, 2 * _GROUP_K, 8, entries, struct.pack('<Q', keys[-1]))
        msgs = [_message(_SYMBOL_TABLE, struct.pack('<QQ', btree, heap_at))]
        msgs += [_attribute_message(k, v) for k, v in group.attrs.items()]
        return self.header(msgs), btree, heap_at


def _write_file(path: str, root: Group) -> None:
    out = _Out()
    out.put(bytes(96))   # the superblock, filled in last
    header, btree, heap = out.group(root)
    out.buf[:96] = (SIGNATURE + struct.pack('<BBBBBBBBHHI', 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                             _GROUP_K, 0)
                    + struct.pack('<QQQQ', 0, UNDEFINED, len(out.buf), UNDEFINED)
                    + struct.pack('<QQI4xQQ', 0, header, 1, btree, heap))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.tmp{os.getpid()}'
    with open(tmp, 'wb') as f:
        f.write(out.buf)
    os.replace(tmp, path)
