"""A reader and writer of HDF5 files of numeric datasets, without h5py.

CLAM's patching step, and ``healnet_tpu/cli/tasks.py``, store each slide's
patch coordinates as ``patches/<slide_id>.h5``: a dataset ``coords``
(``(n, 2)`` int64, level-0 pixels) with the attributes ``patch_size`` and
``patch_level``. The machine with the GPU has no h5py, so the port reads and
writes these files itself, as ``utils/yaml_reader.py`` reads configs.

What :func:`read_dataset` and :func:`read_attrs` read, as h5py writes it:

- superblock version 0, and versions 2 and 3 (``libver="latest"``);
- object headers version 1 and 2, with continuation blocks;
- groups by symbol table (a version 1 B-tree of symbol nodes over a local
  heap) or by link messages (hard links);
- fixed-point and floating-point data of any size and byte order;
- contiguous, compact and chunked storage; chunks indexed by a version 1
  B-tree (h5py's default, and CLAM's resizable ``coords``), or under
  ``libver="latest"`` by a single chunk, a fixed array or an extensible
  array (unpaged);
- the deflate and shuffle filters, through ``zlib`` and numpy;
- unwritten storage read as the dataset's fill value (zero by default).

Anything else raises ``NotImplementedError`` naming what is missing (dense
link or attribute storage in fractal heaps, shared messages, version 2
B-tree chunk indexes, paged arrays, other filters and datatypes).

:func:`write_coords` writes what ``cli/tasks.py`` writes: one contiguous
int64 ``coords`` dataset with two int64 attributes, at superblock version 0.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = (1 << 64) - 1
_SOFT = -1  # a symbol table entry of a soft link

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION = 0x6, 0x8, 0xB, 0xC, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_PathLike = Union[str, Path]


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5: {what} is not supported by healnet_tpu_torch.etl.h5")


class _Reader:
    """Random access to one file's bytes and its superblock's sizes."""

    def __init__(self, buf):
        self.buf = buf
        base = 0
        while buf[base:base + 8] != _SIGNATURE:
            base = 512 if base == 0 else base * 2  # a user block before the superblock
            if base + 8 > len(buf):
                raise ValueError("not an HDF5 file (no superblock signature)")
        version = buf[base + 8]
        if version in (0, 1):
            self.so, self.sl = buf[base + 13], buf[base + 14]
            pos = base + 24 + (4 if version == 1 else 0)
            self.base = self.u(pos, self.so)
            self.root = self.addr(pos + 5 * self.so)  # the root symbol table entry's
        elif version in (2, 3):
            self.so, self.sl = buf[base + 9], buf[base + 10]
            pos = base + 12
            self.base = self.u(pos, self.so)
            self.root = self.addr(pos + 3 * self.so)
        else:
            raise _unsupported(f"superblock version {version}")

    # ------------------------------------------------------------ primitives
    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def addr(self, pos: int) -> int:
        """An address field at ``pos`` as an absolute file position (or
        ``_UNDEF``)."""
        a = self.u(pos, self.so)
        return _UNDEF if a == (1 << (8 * self.so)) - 1 else a + self.base

    def sig(self, pos: int, expected: bytes) -> None:
        if bytes(self.buf[pos:pos + 4]) != expected:
            raise ValueError(f"HDF5: expected {expected!r} at {pos}, found "
                             f"{bytes(self.buf[pos:pos + 4])!r}")

    def read(self, pos: int, n: int) -> bytes:
        return bytes(self.buf[pos:pos + n])

    # -------------------------------------------------------- object headers
    def messages(self, pos: int) -> List[Tuple[int, int, int, int]]:
        """``(type, flags, data position, size)`` of every message of the
        object header at ``pos``, continuation blocks followed."""
        out: List[Tuple[int, int, int, int]] = []
        if bytes(self.buf[pos:pos + 4]) == b"OHDR":
            version, flags = self.buf[pos + 4], self.buf[pos + 5]
            if version != 2:
                raise _unsupported(f"object header version {version}")
            p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            size_len = 1 << (flags & 0x3)
            chunk_size = self.u(p, size_len)
            p += size_len
            blocks = [(p, p + chunk_size)]
            hdr = 4 + (2 if flags & 0x04 else 0)
            while blocks:
                start, end = blocks.pop(0)
                q = start
                while q + hdr <= end:
                    mtype, size, mflags = self.buf[q], self.u(q + 1, 2), self.buf[q + 3]
                    data = q + hdr
                    out.append((mtype, mflags, data, size))
                    if mtype == _CONTINUATION:
                        cont = self.addr(data)
                        self.sig(cont, b"OCHK")
                        blocks.append((cont + 4, cont + self.u(data + self.so, self.sl) - 4))
                    q = data + size
            return out
        version = self.buf[pos]
        if version != 1:
            raise _unsupported(f"object header version {version}")
        nmsgs, size = self.u(pos + 2, 2), self.u(pos + 8, 4)
        blocks = [(pos + 16, pos + 16 + size)]
        while blocks and len(out) < nmsgs:
            start, end = blocks.pop(0)
            q = start
            while q + 8 <= end and len(out) < nmsgs:
                mtype, msize, mflags = self.u(q, 2), self.u(q + 2, 2), self.buf[q + 4]
                out.append((mtype, mflags, q + 8, msize))
                if mtype == _CONTINUATION:
                    cont = self.addr(q + 8)
                    blocks.append((cont, cont + self.u(q + 8 + self.so, self.sl)))
                q += 8 + msize
        return out

    def object_messages(self, pos: int) -> Dict[int, List[Tuple[int, int]]]:
        """Messages by type: ``{type: [(data position, size), ...]}``."""
        by_type: Dict[int, List[Tuple[int, int]]] = {}
        for mtype, mflags, data, size in self.messages(pos):
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL, _FILTERS, _ATTRIBUTE):
                raise _unsupported("a shared object header message")
            by_type.setdefault(mtype, []).append((data, size))
        return by_type

    # ---------------------------------------------------------------- groups
    def children(self, pos: int) -> Dict[str, int]:
        """A group's links: ``{name: object header position}``."""
        msgs = self.object_messages(pos)
        out: Dict[str, int] = {}
        if _SYMBOL_TABLE in msgs:
            data, _ = msgs[_SYMBOL_TABLE][0]
            btree, heap = self.addr(data), self.addr(data + self.so)
            self.sig(heap, b"HEAP")
            heap_data = self.addr(heap + 8 + 2 * self.sl)
            for snod in self.btree_children(btree, 0):
                self.sig(snod, b"SNOD")
                entry = snod + 8
                for _ in range(self.u(snod + 6, 2)):
                    name_at = heap_data + self.u(entry, self.so)
                    end = self.buf.find(b"\x00", name_at)
                    soft = self.u(entry + 2 * self.so, 4) == 2  # the entry's cache type
                    out[self.read(name_at, end - name_at).decode()] = \
                        _SOFT if soft else self.addr(entry + self.so)
                    entry += 2 * self.so + 24
        for data, _ in msgs.get(_LINK_INFO, []):
            flags = self.buf[data + 1]
            if self.addr(data + 2 + (8 if flags & 1 else 0)) != _UNDEF:
                raise _unsupported("dense link storage (a fractal heap)")
        for data, _ in msgs.get(_LINK, []):
            flags = self.buf[data + 1]
            p = data + 2
            link_type = 0
            if flags & 0x08:
                link_type = self.buf[p]
                p += 1
            p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
            n = 1 << (flags & 0x3)
            length = self.u(p, n)
            name = self.read(p + n, length).decode()
            if link_type != 0:
                raise _unsupported(f"a link of type {link_type} ({name!r})")
            out[name] = self.addr(p + n + length)
        return out

    def btree_children(self, node: int, node_type: int, rank: int = 0):
        """Leaf children of a version 1 B-tree: addresses (groups, type 0),
        or ``(address, size, filter mask, offsets)`` (chunks of a
        ``rank``-dimensional layout, type 1)."""
        self.sig(node, b"TREE")
        if self.buf[node + 4] != node_type:
            raise ValueError(f"HDF5: B-tree node of type {self.buf[node + 4]}, wanted {node_type}")
        level, used = self.buf[node + 5], self.u(node + 6, 2)
        p = node + 8 + 2 * self.so
        for _ in range(used):
            if node_type == 0:
                key, p = None, p + self.sl
            else:
                size, mask = self.u(p, 4), self.u(p + 4, 4)
                key = (size, mask, p + 8)
                p += 8 + 8 * rank
            child = self.addr(p)
            p += self.so
            if level > 0:
                yield from self.btree_children(child, node_type, rank)
            else:
                yield child if key is None else (child, key[0], key[1],
                                                 [self.u(key[2] + 8 * i, 8)
                                                  for i in range(rank)])

    def lookup(self, name: str) -> Optional[int]:
        pos = self.root
        for part in [p for p in name.split("/") if p]:
            kids = self.children(pos)
            if part not in kids:
                return None
            pos = kids[part]
            if pos == _SOFT:
                raise _unsupported(f"a soft link ({part!r})")
        return pos


# -------------------------------------------------------------- messages


def _dataspace(r: _Reader, data: int) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """(shape, maxshape), maxshape entries -1 where unlimited; None for a
    null dataspace."""
    version, rank, flags = r.buf[data], r.buf[data + 1], r.buf[data + 2]
    if version == 1:
        p = data + 8
    elif version == 2:
        if r.buf[data + 3] == 2:
            return None
        p = data + 4
    else:
        raise _unsupported(f"dataspace message version {version}")
    dims = tuple(r.u(p + r.sl * i, r.sl) for i in range(rank))
    maxdims = dims
    if flags & 1:
        raw = [r.u(p + r.sl * (rank + i), r.sl) for i in range(rank)]
        maxdims = tuple(-1 if m == (1 << (8 * r.sl)) - 1 else m for m in raw)
    return dims, maxdims


def _datatype(r: _Reader, data: int) -> np.dtype:
    cls, bits = r.buf[data] & 0x0F, r.buf[data + 1]
    size = r.u(data + 4, 4)
    order = ">" if bits & 0x01 else "<"
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise _unsupported(f"a {size}-byte integer")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        if bits & 0x40 or size not in (2, 4, 8):
            raise _unsupported(f"a {size}-byte floating-point type with byte order bits {bits}")
        return np.dtype(f"{order}f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumerated", 9: "variable-length", 10: "array"}
    raise _unsupported(f"the {names.get(cls, str(cls))} datatype class")


def _fill(r: _Reader, msgs, dtype: np.dtype) -> np.ndarray:
    """The dataset's fill value as a 0-d array (zero when none is defined)."""
    raw = b""
    if _FILL in msgs:
        data, _ = msgs[_FILL][0]
        version = r.buf[data]
        if version in (1, 2):
            if version == 1 or r.buf[data + 3]:
                size = r.u(data + 4, 4)
                raw = r.read(data + 8, size)
        elif version == 3:
            if r.buf[data + 1] & 0x20:
                size = r.u(data + 2, 4)
                raw = r.read(data + 6, size)
        else:
            raise _unsupported(f"fill value message version {version}")
    elif _FILL_OLD in msgs:
        data, _ = msgs[_FILL_OLD][0]
        raw = r.read(data + 4, r.u(data, 4))
    if len(raw) == dtype.itemsize:
        return np.frombuffer(raw, dtype=dtype).reshape(())
    return np.zeros((), dtype=dtype)


def _filters(r: _Reader, msgs) -> List[Tuple[int, int, List[int]]]:
    """The filter pipeline: ``[(id, flags, client values), ...]``."""
    if _FILTERS not in msgs:
        return []
    data, _ = msgs[_FILTERS][0]
    version, n = r.buf[data], r.buf[data + 1]
    p = data + (8 if version == 1 else 2)
    out = []
    for _ in range(n):
        fid = r.u(p, 2)
        if version == 1 or fid >= 256:
            name_len = r.u(p + 2, 2)
            p += 4
        else:
            name_len = 0
            p += 2
        flags, nvals = r.u(p, 2), r.u(p + 2, 2)
        p += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        p += name_len
        values = [r.u(p + 4 * i, 4) for i in range(nvals)]
        p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        out.append((fid, flags, values))
    return out


def _unfilter(raw: bytes, pipeline, mask: int) -> bytes:
    """A chunk's bytes with its filters undone, last applied first."""
    for i in reversed(range(len(pipeline))):
        if mask & (1 << i):
            continue
        fid, _flags, values = pipeline[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            size = values[0] if values else 1
            arr = np.frombuffer(raw, dtype=np.uint8)
            n = len(arr) // size
            body = arr[:n * size].reshape(size, n).T.reshape(-1)
            raw = body.tobytes() + arr[n * size:].tobytes()
        else:
            raise _unsupported(f"filter {fid}")
    return raw


# ---------------------------------------------------------------- storage


def _chunk_grid(shape, chunk) -> Tuple[int, ...]:
    return tuple(-(-s // c) for s, c in zip(shape, chunk))


def _place(out: np.ndarray, raw: bytes, offsets, chunk, dtype: np.dtype) -> None:
    """Write one decoded chunk (``chunk`` elements, row-major) at
    ``offsets``, cut at the dataset's edges."""
    block = np.frombuffer(raw, dtype=dtype, count=int(np.prod(chunk))).reshape(chunk)
    dst, src = [], []
    for o, c, s in zip(offsets, chunk, out.shape):
        if o >= s:
            return
        n = min(c, s - o)
        dst.append(slice(o, o + n))
        src.append(slice(0, n))
    out[tuple(dst)] = block[tuple(src)]


def _linear_chunks(r: _Reader, entries, shape, maxshape, chunk, order):
    """``(linear index, address, size, mask)`` -> ``(address, size, mask,
    offsets)``: the linear index runs row-major over the chunk grid of the
    maximum dims, in ``order`` (the unlimited dimension first for an
    extensible array)."""
    grid_dims = [m if m > 0 else s for m, s in zip(maxshape, shape)]
    grid = _chunk_grid(grid_dims, chunk)
    swizzled = [grid[d] for d in order]
    for idx, address, size, mask in entries:
        if address == _UNDEF:
            continue
        scaled = np.unravel_index(idx, swizzled) if len(swizzled) else ()
        offsets = [0] * len(chunk)
        for d, s in zip(order, scaled):
            offsets[d] = int(s) * chunk[d]
        yield address, size, mask, offsets


def _array_element(r: _Reader, p: int, filtered: bool, esize: int, chunk_bytes: int):
    """A fixed or extensible array element: (address, size, filter mask)."""
    address = r.addr(p)
    if not filtered:
        return address, chunk_bytes, 0
    n = esize - r.so - 4
    return address, r.u(p + r.so, n), r.u(p + r.so + n, 4)


def _fixed_array(r: _Reader, header: int, chunk_bytes: int):
    if header == _UNDEF:
        return
    r.sig(header, b"FAHD")
    filtered, esize, page_bits = r.buf[header + 5], r.buf[header + 6], r.buf[header + 7]
    nelmts = r.u(header + 8, r.sl)
    block = r.addr(header + 8 + r.sl)
    if block == _UNDEF:
        return
    if nelmts > (1 << page_bits):
        raise _unsupported("a paged fixed-array index")
    r.sig(block, b"FADB")
    p = block + 6 + r.so
    for i in range(nelmts):
        yield (i, *_array_element(r, p + i * esize, filtered, esize, chunk_bytes))


def _extensible_array(r: _Reader, header: int, chunk_bytes: int):
    if header == _UNDEF:
        return
    r.sig(header, b"EAHD")
    filtered, esize = r.buf[header + 5], r.buf[header + 6]
    max_bits, idx_elmts, dblk_min = r.buf[header + 7], r.buf[header + 8], r.buf[header + 9]
    sblk_min_ptrs, page_bits = r.buf[header + 10], r.buf[header + 11]
    iblock = r.addr(header + 12 + 6 * r.sl)
    if iblock == _UNDEF:
        return
    # the super block table (H5EA__hdr_init)
    nsblks = 1 + (max_bits - int(dblk_min).bit_length() + 1)
    sblk = []
    start_idx = start_dblk = 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        sblk.append((ndblks, nelmts, start_idx, start_dblk))
        start_idx += ndblks * nelmts
        start_dblk += ndblks
    iblock_sblks = 2 * (int(sblk_min_ptrs).bit_length() - 1)
    ndblk_addrs = 2 * (sblk_min_ptrs - 1)
    off_size = (max_bits + 7) // 8
    r.sig(iblock, b"EAIB")
    p = iblock + 6 + r.so
    for i in range(idx_elmts):
        yield (i, *_array_element(r, p + i * esize, filtered, esize, chunk_bytes))
    dblk_addrs = p + idx_elmts * esize
    sblk_addrs = dblk_addrs + ndblk_addrs * r.so
    page_nelmts = 1 << page_bits

    def data_block(address, nelmts, first):
        r.sig(address, b"EADB")
        q = address + 6 + r.so + off_size
        for j in range(nelmts):
            yield (first + j, *_array_element(r, q + j * esize, filtered, esize, chunk_bytes))

    for u, (ndblks, nelmts, s_idx, s_dblk) in enumerate(sblk):
        first = idx_elmts + s_idx
        if nelmts > page_nelmts:
            if any(r.addr(sblk_addrs + (v - iblock_sblks) * r.so) != _UNDEF
                   for v in range(max(u, iblock_sblks), nsblks)):
                raise _unsupported("a paged extensible-array data block")
            break
        if u < iblock_sblks:
            for d in range(ndblks):
                address = r.addr(dblk_addrs + (s_dblk + d) * r.so)
                if address != _UNDEF:
                    yield from data_block(address, nelmts, first + d * nelmts)
            continue
        sb = r.addr(sblk_addrs + (u - iblock_sblks) * r.so)
        if sb == _UNDEF:
            continue
        r.sig(sb, b"EASB")
        q = sb + 6 + r.so + off_size
        for d in range(ndblks):
            address = r.addr(q + d * r.so)
            if address != _UNDEF:
                yield from data_block(address, nelmts, first + d * nelmts)


def _read_storage(r: _Reader, msgs, shape, maxshape, dtype: np.dtype) -> np.ndarray:
    out = np.empty(shape, dtype=dtype)
    out[...] = _fill(r, msgs, dtype)
    data, _ = msgs[_LAYOUT][0]
    version, cls = r.buf[data], r.buf[data + 1]
    if version not in (3, 4):
        raise _unsupported(f"data layout message version {version}")
    nbytes = out.size * dtype.itemsize
    if cls == 0:  # compact
        size = r.u(data + 2, 2)
        out.reshape(-1)[...] = np.frombuffer(r.read(data + 4, size), dtype=dtype,
                                             count=out.size)
        return out
    if cls == 1:  # contiguous
        address = r.addr(data + 2)
        if address != _UNDEF and out.size:
            out.reshape(-1)[...] = np.frombuffer(r.read(address, nbytes), dtype=dtype)
        return out
    if cls != 2:
        raise _unsupported(f"data layout class {cls}")
    pipeline = _filters(r, msgs)
    if version == 3:
        rank = r.buf[data + 2]
        index = r.addr(data + 3)
        chunk = tuple(r.u(data + 3 + r.so + 4 * i, 4) for i in range(rank - 1))
        chunks = []
        if index != _UNDEF:
            chunks = [(a, s, m, offs[:-1]) for a, s, m, offs in r.btree_children(index, 1, rank)]
    else:
        flags, rank, dim_len = r.buf[data + 2], r.buf[data + 3], r.buf[data + 4]
        p = data + 5
        chunk = tuple(r.u(p + dim_len * i, dim_len) for i in range(rank - 1))
        p += dim_len * rank
        index_type = r.buf[p]
        p += 1
        if flags & 0x01 and pipeline:
            raise _unsupported("unfiltered partial edge chunks")
        chunk_bytes = int(np.prod(chunk)) * dtype.itemsize
        unlimited = [d for d, m in enumerate(maxshape) if m < 0]
        order = list(range(len(shape)))
        if index_type == 1:  # a single chunk
            size, mask = chunk_bytes, 0
            if flags & 0x02:
                size, mask = r.u(p, r.sl), r.u(p + r.sl, 4)
                p += r.sl + 4
            entries = [(0, r.addr(p), size, mask)]
        elif index_type == 3:
            entries = list(_fixed_array(r, r.addr(p + 1), chunk_bytes))
        elif index_type == 4:
            entries = list(_extensible_array(r, r.addr(p + 5), chunk_bytes))
            order = unlimited + [d for d in order if d not in unlimited]
        else:
            names = {2: "an implicit chunk index", 5: "a chunk index by version 2 B-tree"}
            raise _unsupported(names.get(index_type, f"chunk index type {index_type}"))
        chunks = list(_linear_chunks(r, entries, shape, maxshape, chunk, order))
    for address, size, mask, offsets in chunks:
        raw = _unfilter(r.read(address, size), pipeline, mask)
        _place(out, raw, offsets, chunk, dtype)
    return out


def _attribute(r: _Reader, data: int) -> Tuple[str, Any]:
    version = r.buf[data]
    name_size, dt_size, ds_size = r.u(data + 2, 2), r.u(data + 4, 2), r.u(data + 6, 2)
    if version == 1:
        pad = lambda n: (n + 7) // 8 * 8
        p = data + 8
    elif version in (2, 3):
        pad = lambda n: n
        p = data + 8 + (1 if version == 3 else 0)
    else:
        raise _unsupported(f"attribute message version {version}")
    name = r.read(p, name_size).rstrip(b"\x00").decode()
    p += pad(name_size)
    dtype = _datatype(r, p)
    p += pad(dt_size)
    space = _dataspace(r, p)
    p += pad(ds_size)
    if space is None:
        return name, None
    shape = space[0]
    count = int(np.prod(shape))
    value = np.frombuffer(r.read(p, count * dtype.itemsize), dtype=dtype).reshape(shape)
    return name, value[()] if shape == () else value.copy()


# ---------------------------------------------------------------- public


def _open(path: _PathLike):
    f = open(path, "rb")
    try:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:  # an empty file cannot be mapped
        f.close()
        raise ValueError(f"{path}: not an HDF5 file (empty)")
    return f, buf


def read_dataset(path: _PathLike, name: str) -> Optional[np.ndarray]:
    """The dataset ``name`` (a ``/``-separated path) of the HDF5 file at
    ``path`` as a numpy array, or None when the file has no such object."""
    f, buf = _open(path)
    try:
        r = _Reader(buf)
        pos = r.lookup(name)
        if pos is None:
            return None
        msgs = r.object_messages(pos)
        if _LAYOUT not in msgs:
            raise ValueError(f"HDF5: {name!r} in {path} is not a dataset")
        space = _dataspace(r, msgs[_DATASPACE][0][0])
        dtype = _datatype(r, msgs[_DATATYPE][0][0])
        if space is None:
            return None
        return _read_storage(r, msgs, space[0], space[1], dtype)
    finally:
        buf.close()
        f.close()


def read_attrs(path: _PathLike, name: str = "/") -> Dict[str, Any]:
    """The attributes of the object ``name`` (default the root group):
    numpy scalars for scalar attributes, arrays otherwise. A missing object
    raises ``KeyError``."""
    f, buf = _open(path)
    try:
        r = _Reader(buf)
        pos = r.lookup(name)
        if pos is None:
            raise KeyError(f"{path} has no object {name!r}")
        msgs = r.object_messages(pos)
        for data, _ in msgs.get(_ATTRIBUTE_INFO, []):
            flags = r.buf[data + 1]
            if r.addr(data + 2 + (2 if flags & 1 else 0)) != _UNDEF:
                raise _unsupported("dense attribute storage (a fractal heap)")
        return dict(_attribute(r, data) for data, _ in msgs.get(_ATTRIBUTE, []))
    finally:
        buf.close()
        f.close()


# ---------------------------------------------------------------- writer


def _message_v1(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\x00" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header_v1(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _int64_attribute(name: str, value: int) -> bytes:
    raw_name = name.encode() + b"\x00"
    pad = lambda b: b + b"\x00" * (-len(b) % 8)
    dtype = _INT64_TYPE
    space = struct.pack("<BBBB4x", 1, 0, 0, 0)  # a scalar dataspace
    return _message_v1(_ATTRIBUTE, struct.pack("<BxHHH", 1, len(raw_name), len(dtype), len(space))
                       + pad(raw_name) + pad(dtype) + pad(space) + struct.pack("<q", value))


# fixed-point, version 1, little-endian, signed; 8 bytes; offset 0, precision 64
_INT64_TYPE = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 8, 0, 64)


def write_coords(path: _PathLike, coords, patch_size: int, patch_level: int) -> None:
    """Write ``coords`` (``(n, 2)``, cast to int64) as the dataset ``coords``
    of a new HDF5 file at ``path``, with the int64 attributes
    ``patch_size`` and ``patch_level`` (what ``cli/tasks.py`` writes with
    h5py): superblock version 0, a symbol-table root group, contiguous
    storage."""
    data = np.ascontiguousarray(np.asarray(coords), dtype="<i8")
    if data.ndim != 2:
        raise ValueError(f"coords must be 2-D, got shape {data.shape}")
    leaf_k, internal_k = 4, 16
    undef = struct.pack("<Q", _UNDEF)

    # layout: superblock | root header | B-tree | symbol node | heap | heap data
    #         | dataset header | raw data
    sb_size = 8 + 8 + 4 + 4 + 4 * 8 + 40
    root_msgs = [_message_v1(_SYMBOL_TABLE, b"\x00" * 16)]
    root_size = len(_object_header_v1(root_msgs))
    root_at = sb_size
    btree_at = root_at + root_size
    btree_size = 8 + 2 * 8 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod_at = btree_at + btree_size
    snod_size = 8 + 2 * leaf_k * 40
    heap_at = snod_at + snod_size
    heap_size = 8 + 2 * 8 + 8
    heap_data = b"\x00" * 8 + b"coords\x00\x00"
    heap_data_at = heap_at + heap_size
    dset_at = heap_data_at + len(heap_data)

    space = struct.pack("<BBBB4x", 1, 2, 0, 0) + struct.pack("<QQ", *data.shape)
    # fill value message version 2: allocated late, written if set, none defined
    fill = struct.pack("<BBBB", 2, 2, 2, 0)
    attrs = [_int64_attribute("patch_size", int(patch_size)),
             _int64_attribute("patch_level", int(patch_level))]

    def dataset_header(raw_at: int) -> bytes:
        # an empty dataset's storage is left unallocated (undefined address)
        layout = struct.pack("<BBQQ", 3, 1, raw_at if data.size else _UNDEF, data.nbytes)
        return _object_header_v1([_message_v1(_DATASPACE, space),
                                  _message_v1(_DATATYPE, _INT64_TYPE, flags=1),
                                  _message_v1(_FILL, fill, flags=1),
                                  _message_v1(_LAYOUT, layout), *attrs])

    raw_at = dset_at + len(dataset_header(0))
    raw_at += -raw_at % 8
    eof = raw_at + data.nbytes

    sb = (_SIGNATURE + struct.pack("<BBBxBBBxHHI", 0, 0, 0, 0, 8, 8, leaf_k, internal_k, 0)
          + struct.pack("<Q", 0) + undef + struct.pack("<Q", eof) + undef
          # the root group's symbol table entry, its B-tree and heap cached
          + struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, heap_at))
    root = _object_header_v1([_message_v1(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))])
    btree = (b"TREE" + struct.pack("<BBH", 0, 0, 1) + undef + undef
             + struct.pack("<QQQ", 0, snod_at, 8))
    btree += b"\x00" * (btree_size - len(btree))
    snod = b"SNOD" + struct.pack("<BxH", 1, 1) + struct.pack("<QQII16x", 8, dset_at, 0, 0)
    snod += b"\x00" * (snod_size - len(snod))
    heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_data_at)

    out = bytearray(eof)
    for at, blob in ((0, sb), (root_at, root), (btree_at, btree), (snod_at, snod),
                     (heap_at, heap), (heap_data_at, heap_data),
                     (dset_at, dataset_header(raw_at)), (raw_at, data.tobytes())):
        out[at:at + len(blob)] = blob
    Path(path).write_bytes(bytes(out))
