"""HDF5 datasets in local files (host NumPy, the native codec and the
standard library; no h5py, no libhdf5).

:class:`H5Dataset` reads a dataset of integers or IEEE floats (either byte
order) from the files ``h5py`` writes under any ``libver`` bounds, with:

- superblock v0 and v1 (``libver`` earliest, the default), v2 (``v108``)
  and v3 (``latest``, SWMR), found at 0, 512, 1024, ... past a user
  block; offsets and lengths of the sizes it states;
- object headers v1 (messages aligned to 8 bytes) and v2 (``OHDR``), with
  their continuation blocks (``OCHK`` in v2);
- groups of the old style (a symbol table message: a v1 B-tree of type 0
  over ``SNOD`` nodes, names in a local heap; soft links as symbol table
  entries of cache type 2) and of the new style (link messages in the
  header, or, in dense storage, a Link Info message: the links in a
  fractal heap, found by walking every record of its v2 B-tree name
  index); hard and soft links are followed;
- the dataspace (v1, v2), the datatype (fixed point and IEEE float, either
  byte order; a committed datatype is followed), the fill value (the old
  message 0x0004 and the new 0x0005, undefined and default read as zero)
  and the data layout v3 and v4: compact, contiguous (an undefined address
  reads as the fill value) and chunked, with every chunk index: the v1
  B-tree (layout v3), and under layout v4 the single chunk (with its
  filtered size and filter mask), the implicit index, the fixed array
  (paged above ``2**page_bits`` entries), the extensible array (index
  block, super blocks, data blocks and their pages) and the v2 B-tree
  (record types 10 and 11).  A chunk the index does not hold reads as the
  fill value; edge chunks are stored at the full chunk size, and under
  layout v4's flag "partial edge chunks not filtered" they are stored raw;
- the filter pipeline (v1, v2) and each chunk's filter mask (a filter the
  mask turns off is skipped for that chunk): deflate (Python's ``zlib``),
  shuffle, Fletcher-32 (verified: a mismatch raises ``OSError``),
  scale-offset (integer, and floating point D-scale) and h5py's LZF
  (filter 32000), the last four in ``io/native/h5codec.cpp``.

Refused by name, with :class:`UnsupportedLayout` (a ``ValueError``) when
the dataset is opened: szip, n-bit and every other filter (Blosc, LZ4,
bitshuffle, zstd and other plugins), external storage, virtual datasets,
external links, shared messages in the file's shared-message heap,
datatypes other than integers and IEEE floats, and a missing native codec.
The metadata checksums (lookup3) are not checked.

``read(lo, hi, dtype)`` returns the elements ``[lo, hi)`` of the leading
axis, every other axis whole: the chunks it needs are read and decoded on
the I/O pool's threads (``io/_shared.py``), a chunk that lies wholly
inside the read, across every other axis, in the output's own type,
straight into the output.  Chunks read only in part are kept, up to
h5py's default chunk cache of 1 MiB, so strided one-frame reads decode
each chunk about as often as h5py does.  ``take(key, dtype)`` follows
h5py's indexing (ints, negative ints, slices with a positive step, tuples
of them) and its errors (``IndexError`` for an index out of range,
``ValueError`` for a step below 1); a key that names no object raises
``KeyError``.
"""
from __future__ import annotations

import math
import os
import threading
import zlib
from collections import OrderedDict

import numpy as np

from sitator_tpu_torch.io._shared import library_usable, native_lib, pool_map

__all__ = ["H5Dataset", "UnsupportedLayout", "codec_libraries",
           "fletcher32", "FILTER_NAMES"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
CHUNK_CACHE_BYTES = 1 << 20        # h5py's default rdcc_nbytes
MAX_LINKS = 16                     # soft links followed in one path

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _EXTERNAL, _LAYOUT, _PIPELINE = 6, 7, 8, 11
_CONTINUATION, _SYMBOL_TABLE = 16, 17
_SHARED = 0x02                     # message flag: stored elsewhere

# filter ids -> names; the first five are decoded here
_DEFLATE, _SHUFFLE, _FLETCHER32, _SZIP, _NBIT, _SCALEOFFSET, _LZF = \
    1, 2, 3, 4, 5, 6, 32000
FILTER_NAMES = {_DEFLATE: "deflate", _SHUFFLE: "shuffle",
                _FLETCHER32: "fletcher32", _SCALEOFFSET: "scale-offset",
                _LZF: "lzf", _SZIP: "szip", _NBIT: "n-bit", 307: "bzip2",
                32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                32013: "zfp", 32015: "zstd", 32026: "blosc2"}
_DECODED = (_DEFLATE, _SHUFFLE, _FLETCHER32, _SCALEOFFSET, _LZF)
_NATIVE = (_SHUFFLE, _FLETCHER32, _SCALEOFFSET, _LZF)

# layout v4 chunk indices
_SINGLE, _IMPLICIT, _FIXED, _EXTENSIBLE, _BTREE2 = 1, 2, 3, 4, 5
_INDEX_NAMES = {0: "v1 B-tree", _SINGLE: "single chunk",
                _IMPLICIT: "implicit", _FIXED: "fixed array",
                _EXTENSIBLE: "extensible array", _BTREE2: "v2 B-tree"}
_NO_FILTER_EDGES = 0x01            # layout v4 flags
_SINGLE_FILTERED = 0x02

# IEEE layouts: item size -> (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}


class UnsupportedLayout(ValueError):
    """An HDF5 feature this reader does not decode here: one it does not
    implement, or a filter whose library is not usable.  Raised when the
    dataset is opened."""


def _codec():
    return native_lib()


def codec_libraries():
    """``{library: usable here}`` for what the filters need: the native
    codec and ``libz.so.1`` (deflate goes through Python's ``zlib``)."""
    return {"h5codec": _codec() is not None,
            "libz.so.1": library_usable("libz.so.1")}


def _u8(data):
    return np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else data.reshape(-1).view(np.uint8)


def fletcher32(data):
    """HDF5's Fletcher-32 of a bytes-like object or array."""
    buf = np.ascontiguousarray(_u8(data))
    return int(_codec().h5c_fletcher32(buf.ctypes.data, buf.size))


def _log2(n):
    return max(int(n), 1).bit_length() - 1


def _enc_size(n):
    """Bytes that encode counts up to ``n`` (H5VM_limit_enc_size)."""
    return _log2(n) // 8 + 1


class _Cursor:
    """Little-endian fields of a block of the file, in order."""

    __slots__ = ("b", "p", "o", "l")

    def __init__(self, data, f, pos=0):
        self.b, self.p, self.o, self.l = data, pos, f.O, f.L

    def u(self, n):
        v = int.from_bytes(self.b[self.p:self.p + n], "little")
        self.p += n
        return v

    def addr(self):
        return self.u(self.o)

    def length(self):
        return self.u(self.l)

    def take(self, n):
        v = self.b[self.p:self.p + n]
        self.p += n
        return bytes(v)

    def skip(self, n):
        self.p += n
        return self


class _File:
    """The file: its superblock, object headers, groups and heaps."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._fh = open(self.path, "rb", buffering=0)
        self._fd = self._fh.fileno()
        self._headers = {}
        try:
            self._superblock()
        except BaseException:
            self._fh.close()
            raise

    def close(self):
        self._fh.close()

    def fault(self, what):
        return OSError(f"{self.path}: {what}")

    # -- bytes
    def pread(self, pos, n, exact=True):
        b = os.pread(self._fd, n, pos)
        if exact and len(b) != n:
            raise self.fault(f"short read ({len(b)} of {n} bytes at "
                             f"{pos}): truncated file")
        return b

    def read(self, addr, n):
        return self.pread(self.base + addr, n)

    def read_into(self, addr, buf):
        """Read ``buf.nbytes`` bytes at ``addr`` into the writable array."""
        view = memoryview(buf.reshape(-1).view(np.uint8))
        got = os.preadv(self._fd, [view], self.base + addr)
        if got != view.nbytes:
            raise self.fault(f"short read ({got} of {view.nbytes} bytes at "
                             f"{self.base + addr}): truncated file")

    def cursor(self, addr, n):
        return _Cursor(self.read(addr, n), self)

    def defined(self, addr):
        return addr != self.undefined

    def signature(self, data, sig, addr):
        if bytes(data[:4]) != sig:
            raise self.fault(f"expected {sig.decode()!r} at address {addr}, "
                             f"found {bytes(data[:4])!r}")

    # -- superblock
    def _superblock(self):
        size = os.fstat(self._fd).st_size
        at = 0
        while at + 8 <= size and self.pread(at, 8, False) != SIGNATURE:
            at = 512 if at == 0 else 2 * at
        if at + 8 > size:
            raise self.fault("not an HDF5 file (no superblock signature at "
                             "0, 512, 1024, ...)")
        head = self.pread(at, 16, False)
        version = head[8]
        if version in (0, 1):
            self.O, self.L = head[13], head[14]
            c = _Cursor(self.pread(at, 56 + 6 * head[13]), self,
                        24 + (4 if version == 1 else 0))
            c.addr()                        # base address
            c.skip(3 * self.O)              # free space, end of file, driver
            c.addr()                        # root entry: link name offset
            root = c.addr()
        elif version in (2, 3):
            self.O, self.L = head[9], head[10]
            c = _Cursor(self.pread(at, 12 + 4 * self.O), self, 12)
            c.skip(3 * self.O)              # base, extension, end of file
            root = c.addr()
        else:
            raise UnsupportedLayout(f"{self.path}: HDF5 superblock version "
                                    f"{version} is not supported (0-3 are)")
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise UnsupportedLayout(f"{self.path}: HDF5 offsets of {self.O} "
                                    f"and lengths of {self.L} bytes")
        self.base = at                      # addresses count from here
        self.undefined = (1 << (8 * self.O)) - 1
        self.root = root

    # -- object headers
    def messages(self, addr):
        """(type, flags, body) of every message of the object header at
        ``addr``, continuation blocks included."""
        if addr in self._headers:
            return self._headers[addr]
        head = self.pread(self.base + addr, 40, False)
        if head[:4] == b"OHDR":
            flags = head[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            w = 1 << (flags & 3)
            blocks = [(addr + p + w, int.from_bytes(head[p:p + w], "little"))]
            hsize = 6 if flags & 0x04 else 4
            v2 = True
        elif head[0] == 1:
            blocks = [(addr + 16, int.from_bytes(head[8:12], "little"))]
            hsize, v2 = 8, False
        else:
            raise self.fault(f"no object header at address {addr}")
        out = []
        while blocks:
            start, n = blocks.pop(0)
            data = self.read(start, n)
            p = 0
            while p + hsize <= n:
                if v2:
                    mtype, size, mflags = (data[p], int.from_bytes(
                        data[p + 1:p + 3], "little"), data[p + 3])
                else:
                    mtype = int.from_bytes(data[p:p + 2], "little")
                    size = int.from_bytes(data[p + 2:p + 4], "little")
                    mflags = data[p + 4]
                body = data[p + hsize:p + hsize + size]
                p += hsize + size
                if mtype == _CONTINUATION:
                    c = _Cursor(body, self)
                    at, length = c.addr(), c.length()
                    if v2:
                        self.signature(self.read(at, 4), b"OCHK", at)
                        blocks.append((at + 4, length - 8))
                    else:
                        blocks.append((at, length))
                elif mtype != _NIL:
                    out.append((mtype, mflags, body))
        self._headers[addr] = out
        return out

    def message(self, msgs, mtype, what):
        """The body of the one message of ``mtype``, a shared one read
        where it is stored; None if there is none."""
        for t, flags, body in msgs:
            if t != mtype:
                continue
            if not flags & _SHARED:
                return body
            version, kind = body[0], body[1]
            if version == 3 and kind == 2 or version < 3 and kind in (0, 2):
                c = _Cursor(body, self, 8 if version == 1 else 2)
                return self.message(self.messages(c.addr()), mtype, what)
            raise UnsupportedLayout(
                f"{self.path}: the {what} is a shared message in the file's "
                "shared-message heap, which this reader does not read")
        return None

    # -- groups
    def links(self, addr):
        """(name, kind, target) of every link of the group at ``addr``:
        kind ``'hard'`` (target an object header address), ``'soft'`` (a
        path) or another kind (target None)."""
        msgs = self.messages(addr)
        for t, _, body in msgs:
            if t == _SYMBOL_TABLE:
                yield from self._symbol_table(body)
                return
        for t, _, body in msgs:
            if t == _LINK:
                yield _link(body, self)
            elif t == _LINK_INFO:
                yield from self._dense_links(body)

    def _symbol_table(self, body):
        c = _Cursor(body, self)
        tree, heap = c.addr(), c.addr()
        h = self.cursor(heap, 8 + 2 * self.L + self.O)
        self.signature(h.b, b"HEAP", heap)
        h.skip(8)
        size = h.length()
        h.length()
        names = self.read(h.addr(), size)

        def name_at(off):
            return names[off:names.index(b"\0", off)].decode("utf-8")

        entry = 2 * self.O + 24
        for _, node in self._btree1(tree, self.L):
            s = self.read(node, 8)
            self.signature(s, b"SNOD", node)
            n = int.from_bytes(s[6:8], "little")
            data = self.read(node + 8, n * entry)
            for i in range(n):
                e = _Cursor(data, self, i * entry)
                name, obj, cache = name_at(e.addr()), e.addr(), e.u(4)
                if cache == 2:
                    e.skip(4)
                    yield name, "soft", name_at(e.u(4))
                else:
                    yield name, "hard", obj

    def _btree1(self, addr, key_size):
        """(key bytes, child address) of every entry of the leaves of the
        v1 B-tree at ``addr``."""
        head = self.read(addr, 8 + 2 * self.O)
        self.signature(head, b"TREE", addr)
        level = head[5]
        n = int.from_bytes(head[6:8], "little")
        step = key_size + self.O
        data = self.read(addr + 8 + 2 * self.O, n * step + key_size)
        for i in range(n):
            key = data[i * step:i * step + key_size]
            child = int.from_bytes(data[i * step + key_size:(i + 1) * step],
                                   "little")
            if level:
                yield from self._btree1(child, key_size)
            else:
                yield key, child

    def _dense_links(self, body):
        c = _Cursor(body, self, 2)
        if body[1] & 0x01:
            c.skip(8)                       # maximum creation index
        heap_addr, names = c.addr(), c.addr()
        if not self.defined(heap_addr) or not self.defined(names):
            return
        heap = _FractalHeap(self, heap_addr)
        for rec in self.btree2(names):
            yield _link(heap.get(rec[4:]), self)

    def btree2(self, addr):
        """Every record (bytes) of the v2 B-tree at ``addr``, internal
        nodes' records included."""
        c = self.cursor(addr, 16 + self.O + 2 + self.L)
        self.signature(c.b, b"BTHD", addr)
        c.skip(6)
        node_size, rsize, depth = c.u(4), c.u(2), c.u(2)
        c.skip(2)
        root, nrec = c.addr(), c.u(2)
        if not self.defined(root):
            return []
        # the widths of the child pointers' record counts at each depth
        leaf_max = (node_size - 10) // rsize
        nrec_size = _enc_size(leaf_max)
        cum, cum_size = [leaf_max], [0]
        for d in range(1, depth + 1):
            ptr = self.O + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            nmax = (node_size - (10 + ptr)) // (rsize + ptr)
            cum.append((nmax + 1) * cum[d - 1] + nmax)
            cum_size.append(_enc_size(cum[d]))
        out = []

        def walk(at, n, d):
            data = self.read(at, node_size)
            self.signature(data, b"BTIN" if d else b"BTLF", at)
            out.extend(data[6 + i * rsize:6 + (i + 1) * rsize]
                       for i in range(n))
            if not d:
                return
            p = _Cursor(data, self, 6 + n * rsize)
            for _ in range(n + 1):
                child, cn = p.addr(), p.u(nrec_size)
                if d > 1:
                    p.u(cum_size[d - 1])
                walk(child, cn, d - 1)

        walk(root, nrec, depth)
        return out

    def lookup(self, addr, name):
        for n, kind, target in self.links(addr):
            if n == name:
                return kind, target
        return None

    def resolve(self, path, start=None, depth=0):
        """The object header address ``path`` names, following links."""
        if depth > MAX_LINKS:
            raise KeyError(f"{path!r}: more than {MAX_LINKS} soft links")
        addr = self.root if start is None or path.startswith("/") else start
        parts = [p for p in path.split("/") if p not in ("", ".")]
        for i, name in enumerate(parts):
            link = self.lookup(addr, name)
            where = "/".join(parts[:i + 1])
            if link is None:
                raise KeyError(f"Unable to open object (object {where!r} "
                               "doesn't exist)")
            kind, target = link
            if kind == "hard":
                addr = target
            elif kind == "soft":
                addr = self.resolve(target, addr, depth + 1)
            else:
                raise UnsupportedLayout(
                    f"{self.path}: {where!r} is {kind}, which this reader "
                    "does not follow")
        return addr


def _link(body, f):
    """(name, kind, target) of a link message."""
    flags = body[1]
    c = _Cursor(body, f, 2)
    ltype = c.u(1) if flags & 0x08 else 0
    c.skip((8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0))
    name = c.take(c.u(1 << (flags & 3))).decode("utf-8")
    if ltype == 0:
        return name, "hard", c.addr()
    if ltype == 1:
        return name, "soft", c.take(c.u(2)).decode("utf-8")
    kind = "an external link" if ltype == 64 else f"a link of type {ltype}"
    return name, kind, None


class _FractalHeap:
    """The managed and tiny objects of a fractal heap."""

    def __init__(self, f, addr):
        self.f = f
        O, L = f.O, f.L
        c = f.cursor(addr, 22 + 12 * L + 3 * O)
        f.signature(c.b, b"FRHP", addr)
        c.skip(5)
        self.id_len, filters = c.u(2), c.u(2)
        if filters:
            raise UnsupportedLayout(f"{f.path}: a filtered fractal heap is "
                                    "not supported")
        c.skip(1)                           # flags
        max_managed = c.u(4)
        # huge objects, free space and the statistics
        c.skip(L + O + L + O + 4 * L + 4 * L)
        self.width, self.start = c.u(2), c.length()
        max_direct, max_bits = c.length(), c.u(2)
        c.skip(2)                           # starting rows of the root
        self.root, self.rows = c.addr(), c.u(2)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8,
                            _enc_size(max_managed))
        self.first_row_bits = _log2(self.start) + _log2(self.width)
        self.max_direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self._iblocks = {}

    def row_size(self, r):
        return self.start if r == 0 else self.start << (r - 1)

    def row_off(self, r):
        return 0 if r == 0 else (self.start * self.width) << (r - 1)

    def _row_col(self, off):
        if off < self.start * self.width:
            return 0, off // self.start
        high = _log2(off)
        row = high - self.first_row_bits + 1
        return row, (off - (1 << high)) // self.row_size(row)

    def _iblock(self, addr, nrows):
        if addr not in self._iblocks:
            f = self.f
            n = nrows * self.width
            c = f.cursor(addr, 5 + f.O + self.off_size + n * f.O)
            f.signature(c.b, b"FHIB", addr)
            c.skip(5 + f.O + self.off_size)
            self._iblocks[addr] = [c.addr() for _ in range(n)]
        return self._iblocks[addr]

    def get(self, heap_id):
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:                        # tiny: the object is the id
            if self.id_len <= 18:
                return bytes(heap_id[1:1 + (heap_id[0] & 0x0F) + 1])
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return bytes(heap_id[2:2 + n])
        if kind != 0:
            raise UnsupportedLayout(f"{self.f.path}: a huge object in a "
                                    "fractal heap is not supported")
        c = _Cursor(heap_id, self.f, 1)
        off, n = c.u(self.off_size), c.u(self.len_size)
        if self.rows == 0:                   # the root is a direct block
            return self.f.read(self.root + off, n)
        addr, nrows, base = self.root, self.rows, 0
        while True:
            row, col = self._row_col(off - base)
            entry = self._iblock(addr, nrows)[row * self.width + col]
            base += self.row_off(row) + col * self.row_size(row)
            if row < self.max_direct_rows:
                return self.f.read(entry + (off - base), n)
            addr = entry
            nrows = _log2(self.row_size(row)) - self.first_row_bits + 1


# ------------------------------------------------------------- dataset
def _datatype(body, where):
    cls, bits = body[0] & 0x0F, body[1]
    size = int.from_bytes(body[4:8], "little")
    offset = int.from_bytes(body[8:10], "little")
    precision = int.from_bytes(body[10:12], "little")
    if cls == 0:
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise UnsupportedLayout(f"{where}: an integer of {precision} "
                                    f"bits at offset {offset} in {size} "
                                    "bytes is not supported")
        return np.dtype(f"{'>' if bits & 1 else '<'}"
                        f"{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        order = (bits & 1) | ((bits >> 5) & 2)
        layout = tuple(body[12:16]) + (int.from_bytes(body[16:20],
                                                      "little"),)
        if order > 1 or size not in _IEEE or offset or \
                precision != 8 * size or layout != _IEEE[size]:
            raise UnsupportedLayout(f"{where}: a float of {size} bytes that "
                                    "is not IEEE (or in VAX order) is not "
                                    "supported")
        return np.dtype(f"{'>' if order else '<'}f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enum",
             9: "variable-length", 10: "array"}
    raise UnsupportedLayout(f"{where}: the HDF5 {names.get(cls, cls)} "
                            "datatype is not supported (integers and IEEE "
                            "floats are)")


def _dataspace(body, f, where):
    version, ndims, flags = body[0], body[1], body[2]
    if version == 2 and body[3] != 1:
        raise UnsupportedLayout(f"{where}: a "
                                f"{'scalar' if body[3] == 0 else 'null'} "
                                "dataspace is not supported")
    c = _Cursor(body, f, 8 if version == 1 else 4)
    shape = tuple(c.length() for _ in range(ndims))
    maxshape = tuple(c.length() for _ in range(ndims)) if flags & 1 \
        else shape
    if not ndims:
        raise UnsupportedLayout(f"{where}: a scalar dataspace is not "
                                "supported")
    return shape, maxshape


def _fill(msgs, dtype):
    """The fill value: a user-defined one, else zero."""
    for t, _, body in msgs:
        if t == _FILL:
            version = body[0]
            if version < 3:
                if version == 1 or body[3]:
                    size = int.from_bytes(body[4:8], "little")
                    raw = body[8:8 + size]
                else:
                    raw = b""
            elif body[1] & 0x20:
                size = int.from_bytes(body[2:6], "little")
                raw = body[6:6 + size]
            else:
                raw = b""
            break
    else:
        raw = next((body[4:4 + int.from_bytes(body[:4], "little")]
                    for t, _, body in msgs if t == _FILL_OLD), b"")
    if len(raw) == dtype.itemsize:
        return np.frombuffer(bytes(raw), dtype)[0]
    return dtype.type(0)


def _pipeline(body):
    """(id, flags, client data) of each filter, in encode order."""
    version, n = body[0], body[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = int.from_bytes(body[p:p + 2], "little")
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = int.from_bytes(body[p:p + 2], "little")
            p += 2
        flags = int.from_bytes(body[p:p + 2], "little")
        ncd = int.from_bytes(body[p + 2:p + 4], "little")
        p += 4
        p += (name_len + 7) // 8 * 8 if version == 1 else name_len
        cd = np.frombuffer(bytes(body[p:p + 4 * ncd]), "<u4").copy()
        p += 4 * ncd
        if version == 1 and ncd % 2:
            p += 4
        out.append((fid, flags, cd))
    return out


def _entries(raw, n, esize, O, stride=None):
    """(address, size, filter mask) arrays of ``n`` chunk index entries of
    ``esize`` bytes each, ``stride`` bytes apart (default ``esize``): an
    address, then (filtered entries) the chunk's size and its 4-byte filter
    mask."""
    stride = stride or esize
    a = np.frombuffer(raw, np.uint8, n * stride).reshape(n, stride)

    def field(lo, width):
        w = np.zeros((n, 8), np.uint8)
        w[:, :width] = a[:, lo:lo + width]
        return w.view("<u8")[:, 0]

    addr = field(0, O)
    if esize == O:
        return addr, None, None
    size_len = esize - O - 4
    return addr, field(O, size_len), field(O + size_len, 4)


class H5Dataset:
    """The dataset ``key`` (a path through groups and links) of the HDF5
    file at ``path``.

    Attributes: ``shape``, ``maxshape``, ``dtype`` (as stored, with its
    byte order), ``fill_value``, ``layout`` (``'compact'``,
    ``'contiguous'`` or ``'chunked'``), ``chunks`` (None unless chunked),
    ``index`` (the chunk index's name), ``filters`` ((id, flags, client
    data) in encode order).  Raises ``KeyError`` if ``key`` names nothing,
    ``OSError`` for a file that is not HDF5 or is damaged, and
    :class:`UnsupportedLayout` for a feature this reader does not decode.
    """

    def __init__(self, path, key="positions"):
        self.path, self.key = os.fspath(path), str(key)
        self._f = _File(self.path)
        try:
            self._open(self._f.messages(self._f.resolve(self.key)))
        except BaseException:
            self._f.close()
            raise
        self._lock = threading.Lock()
        self._index_map = None
        self._cache = OrderedDict()          # chunk -> decoded array
        self._cache_bytes = 0
        self._local = threading.local()      # each thread's scratch

    def close(self):
        self._f.close()

    def __len__(self):
        return self.shape[0]

    @property
    def ndim(self):
        return len(self.shape)

    def _refuse(self, what):
        return UnsupportedLayout(f"{self.path}: {self.key}: {what}")

    def _open(self, msgs):
        f, where = self._f, f"{self.path}: {self.key}"
        types = {t for t, _, _ in msgs}
        if _EXTERNAL in types:
            raise self._refuse("external storage (the External Data Files "
                               "message) is not supported")
        if not {_DATASPACE, _DATATYPE, _LAYOUT} <= types:
            raise ValueError(f"{where} is not a dataset")
        self.dtype = _datatype(f.message(msgs, _DATATYPE, "datatype"), where)
        self.shape, self.maxshape = _dataspace(
            f.message(msgs, _DATASPACE, "dataspace"), f, where)
        self.fill_value = _fill(msgs, self.dtype)
        pipe = f.message(msgs, _PIPELINE, "filter pipeline")
        self.filters = _pipeline(pipe) if pipe is not None else []
        for fid, _, cd in self.filters:
            name = FILTER_NAMES.get(fid, f"with id {fid}")
            if fid not in _DECODED:
                raise self._refuse(
                    f"the HDF5 filter {name} (id {fid}) is not supported "
                    "(deflate, shuffle, fletcher32, scale-offset and lzf "
                    "are)")
            if fid == _SCALEOFFSET and (len(cd) < 8 or cd[0] == 1):
                raise self._refuse("scale-offset with E-scale is not "
                                   "supported (D-scale and integer are)")
            if fid in _NATIVE and _codec() is None:
                raise self._refuse(
                    f"the HDF5 filter {name} needs the native codec "
                    "(io/native/h5codec.cpp, built with g++), which is not "
                    "usable here")
        self._layout(f.message(msgs, _LAYOUT, "data layout"))

    def _layout(self, body):
        f = self._f
        version, cls = body[0], body[1]
        self.chunks, self.index = None, None
        if version < 3:
            raise self._refuse(f"data layout message version {version} is "
                               "not supported (3 and 4 are)")
        c = _Cursor(body, f, 2)
        if cls == 0:
            self.layout = "compact"
            raw = c.take(c.u(2))
            n = math.prod(self.shape) * self.dtype.itemsize
            if len(raw) < n:
                raise f.fault(f"{self.key}: {len(raw)} bytes of compact data "
                              f"for {n}")
            self._compact = np.frombuffer(raw, self.dtype,
                                          math.prod(self.shape)).reshape(
                                              self.shape)
            return
        if cls == 1:
            self.layout = "contiguous"
            self._addr, self._size = c.addr(), c.length()
            return
        if cls == 3:
            raise self._refuse("a virtual dataset is not supported")
        if cls != 2:
            raise self._refuse(f"data layout class {cls} is not supported")
        self.layout = "chunked"
        self._flags = 0
        if version == 3:
            ndims = c.u(1)
            self._addr = c.addr()
            dims = [c.u(4) for _ in range(ndims)]
            kind = 0
        else:
            self._flags, ndims, width = c.u(1), c.u(1), c.u(1)
            dims = [c.u(width) for _ in range(ndims)]
            kind = c.u(1)
            if kind == _SINGLE and self._flags & _SINGLE_FILTERED:
                self._single = c.length(), c.u(4)
            elif kind == _FIXED:
                c.skip(1)
            elif kind == _EXTENSIBLE:
                c.skip(5)
            elif kind == _BTREE2:
                c.skip(6)
            elif kind not in (_SINGLE, _IMPLICIT):
                raise self._refuse(f"chunk index type {kind} is not "
                                   "supported")
            self._addr = c.addr()
        self.chunks = tuple(int(d) for d in dims[:-1])
        if len(self.chunks) != self.ndim or dims[-1] != self.dtype.itemsize:
            raise f.fault(f"{self.key}: chunk dimensions {dims} do not fit "
                          f"a {self.ndim}-d dataset of {self.dtype}")
        self._kind = kind
        self.index = _INDEX_NAMES[kind]
        self.grid = tuple(-(-s // c) for s, c in zip(self.shape,
                                                     self.chunks))
        self._chunk_bytes = math.prod(self.chunks) * self.dtype.itemsize

    # -- the chunk index: chunk (scaled coordinates) -> (address, size, mask)
    def _max_chunks(self):
        unlimited = (1 << (8 * self._f.L)) - 1
        return [None if m == unlimited else -(-m // c)
                for m, c in zip(self.maxshape, self.chunks)]

    def _linear(self, n, swizzle=None):
        """The scaled coordinates of the chunks of linear indices
        ``arange(n)`` (``swizzle``: the unlimited axis, which counts
        slowest)."""
        dims = self._max_chunks()
        order = list(range(self.ndim))
        if swizzle is not None:
            order = [swizzle] + [d for d in order if d != swizzle]
        extents = [dims[d] or 1 for d in order]
        idx = np.arange(n, dtype=np.int64)
        coords = [None] * self.ndim
        for k in range(self.ndim - 1, 0, -1):
            coords[order[k]] = idx % extents[k]
            idx = idx // extents[k]
        coords[order[0]] = idx
        return np.stack(coords, 1)

    def _chunk_index(self):
        with self._lock:
            if self._index_map is None:
                self._index_map = self._load_index()
            return self._index_map

    def _load_index(self):
        f, kind, rank = self._f, self._kind, self.ndim
        out = {}
        if not f.defined(self._addr):
            return out
        if kind == 0:
            key_size = 8 + 8 * (rank + 1)
            for key, child in f._btree1(self._addr, key_size):
                k = np.frombuffer(bytes(key), "<u8", rank, 8)
                out[tuple(int(o) // c for o, c in zip(k, self.chunks))] = (
                    child, int.from_bytes(key[:4], "little"),
                    int.from_bytes(key[4:8], "little"))
        elif kind == _SINGLE:
            size, mask = getattr(self, "_single", (self._chunk_bytes, 0))
            out[(0,) * rank] = self._addr, size, mask
        elif kind == _IMPLICIT:
            n = math.prod(self._max_chunks())
            for k, scaled in enumerate(self._linear(n)):
                out[tuple(int(s) for s in scaled)] = (
                    self._addr + k * self._chunk_bytes, self._chunk_bytes, 0)
        elif kind == _BTREE2:
            recs = f.btree2(self._addr)
            if recs:
                esize = len(recs[0]) - 8 * rank
                raw = b"".join(recs)
                a, s, m = _entries(raw, len(recs), esize, f.O,
                                   len(recs[0]))
                rows = np.frombuffer(raw, np.uint8).reshape(len(recs), -1)
                scaled = rows[:, esize:].copy().view("<u8")
                self._add(out, a, s, m, scaled)
        else:
            a, s, m, n = (self._fixed_array() if kind == _FIXED
                          else self._extensible_array())
            self._add(out, a, s, m, self._linear(n, None if kind == _FIXED
                                                 else self._unlimited()))
        return out

    def _add(self, out, addr, size, mask, scaled):
        undefined = self._f.undefined
        for k in range(len(addr)):
            if int(addr[k]) == undefined:
                continue
            out[tuple(int(x) for x in scaled[k])] = (
                int(addr[k]),
                self._chunk_bytes if size is None else int(size[k]),
                0 if mask is None else int(mask[k]))

    def _unlimited(self):
        unlimited = (1 << (8 * self._f.L)) - 1
        axes = [d for d, m in enumerate(self.maxshape) if m == unlimited]
        return axes[0] if axes else 0

    def _fixed_array(self):
        """(addresses, sizes, masks, n) of a fixed array index."""
        f, O = self._f, self._f.O
        c = f.cursor(self._addr, 8 + f.L + O)
        f.signature(c.b, b"FAHD", self._addr)
        c.skip(6)
        esize, page_bits = c.u(1), c.u(1)
        n, dblk = c.length(), c.addr()
        head = f.read(dblk, 6 + O)
        f.signature(head, b"FADB", dblk)
        page = 1 << page_bits
        if n <= page:
            raw = f.read(dblk + 6 + O, n * esize)
        else:
            npages = -(-n // page)
            bitmap = (npages + 7) // 8
            init = np.unpackbits(np.frombuffer(
                f.read(dblk + 6 + O, bitmap), np.uint8))
            at = dblk + 6 + O + bitmap + 4
            parts = []
            for p in range(npages):
                m = min(page, n - p * page)
                parts.append(f.read(at, m * esize) if init[p]
                             else b"\xff" * (m * esize))
                at += page * esize + 4
            raw = b"".join(parts)
        return (*_entries(raw, n, esize, O), n)

    def _extensible_array(self):
        """(addresses, sizes, masks, n) of an extensible array index: every
        element up to the largest index set."""
        f, O, L = self._f, self._f.O, self._f.L
        c = f.cursor(self._addr, 12 + 6 * L + O)
        f.signature(c.b, b"EAHD", self._addr)
        c.skip(6)
        esize, max_bits, iblk_n, dblk_min, sblk_min, page_bits = (
            c.u(1) for _ in range(6))
        c.skip(4 * L)
        n, _ = c.length(), c.length()       # largest index set, realized
        iblock = c.addr()
        off_size = (max_bits + 7) // 8
        page = 1 << page_bits
        # super block k: 2**(k // 2) data blocks of 2**((k + 1) // 2) *
        # dblk_min elements each
        nsblks = 1 + max_bits - _log2(dblk_min)
        ib_sblks = 2 * _log2(sblk_min)
        ib_dblks = 2 * (sblk_min - 1)
        raw = bytearray(b"\xff" * (n * esize))
        if not f.defined(iblock):
            return (*_entries(bytes(raw), n, esize, O), n)
        ib = f.read(iblock, 6 + O + iblk_n * esize
                    + (ib_dblks + nsblks - ib_sblks) * O)
        f.signature(ib, b"EAIB", iblock)
        p = 6 + O
        k = min(iblk_n, n)
        raw[:k * esize] = ib[p:p + k * esize]
        p += iblk_n * esize
        ptrs = _Cursor(ib, f, p)
        dblk_addrs = [ptrs.addr() for _ in range(ib_dblks)]
        sblk_addrs = [ptrs.addr() for _ in range(nsblks - ib_sblks)]
        start, start_dblk = iblk_n, 0
        for s in range(nsblks):
            if start >= n:
                break
            count, size = 1 << (s // 2), (1 << ((s + 1) // 2)) * dblk_min
            npages = size // page if size > page else 0
            init = None
            if s < ib_sblks:
                addrs = dblk_addrs[start_dblk:start_dblk + count]
            else:
                at = sblk_addrs[s - ib_sblks]
                if not f.defined(at):
                    addrs = []
                else:
                    # one bit a page, data block after data block, in
                    # whole bytes a data block
                    bitmap = count * ((npages + 7) // 8)
                    sb = f.read(at, 6 + O + off_size + bitmap + count * O)
                    f.signature(sb, b"EASB", at)
                    q = 6 + O + off_size
                    init = np.unpackbits(np.frombuffer(sb[q:q + bitmap],
                                                       np.uint8))
                    cur = _Cursor(sb, f, q + bitmap)
                    addrs = [cur.addr() for _ in range(count)]
            for j, at in enumerate(addrs):
                lo = start + j * size
                if lo >= n or not f.defined(at):
                    continue
                m = min(size, n - lo)
                prefix = 6 + O + off_size
                if not npages:
                    raw[lo * esize:(lo + m) * esize] = f.read(
                        at + prefix, m * esize)
                    continue
                for q in range(npages):
                    a = lo + q * page
                    if a >= n or not init[j * npages + q]:
                        continue
                    mm = min(page, n - a)
                    raw[a * esize:(a + mm) * esize] = f.read(
                        at + prefix + 4 + q * (page * esize + 4), mm * esize)
            start += count * size
            start_dblk += count
        return (*_entries(bytes(raw), n, esize, O), n)

    def chunk_info(self):
        """(chunk offset in elements, absolute byte offset in the file,
        stored size, filter mask) of every chunk the index holds, sorted
        by chunk offset (None for a dataset that is not chunked)."""
        if self.layout != "chunked":
            return None
        return sorted((tuple(s * c for s, c in zip(k, self.chunks)),
                       self._f.base + a, n, m)
                      for k, (a, n, m) in self._chunk_index().items())

    # -- decoding
    def _label(self, idx):
        return (f"{self.path}: {self.key}: the chunk at "
                f"{tuple(i * c for i, c in zip(idx, self.chunks))}")

    def _decode(self, idx, raw, mask, dst):
        """The chunk's stored bytes through the filters its mask leaves on,
        into ``dst`` (a uint8 array of the chunk's size) or a new array.
        Every step but the last writes into this thread's scratch; where
        the last step only checks a Fletcher-32 sum (the filter first in
        the pipeline), the result is copied out of the scratch."""
        active = [flt for k, flt in enumerate(self.filters)
                  if not (mask >> k) & 1]
        if self._flags & _NO_FILTER_EDGES and any(
                (i + 1) * c > s for i, c, s in zip(idx, self.chunks,
                                                   self.shape)):
            active = []                     # a partial edge chunk, raw
        data = _u8(raw)
        n = self._chunk_bytes
        slot = 0                            # the scratch the next step fills
        in_scratch = False                  # whether ``data`` lies there
        for k, (fid, _, cd) in enumerate(reversed(active)):
            if fid == _FLETCHER32:
                data = self._fletcher32(idx, data)      # a view of its input
                continue
            if fid == _DEFLATE:
                data, in_scratch = self._inflate(idx, data), False
                continue
            in_scratch = k < len(active) - 1
            if in_scratch:
                out, slot = self._scratch(slot, n + 64), 1 - slot
            else:
                out = dst if dst is not None else np.empty(n, np.uint8)
            if fid == _SHUFFLE:
                if out.size < data.size:
                    raise OSError(f"{self._label(idx)}: {data.size} bytes "
                                  f"where the chunk has {n}")
                out = out[:data.size]
                _codec().h5c_unshuffle(data.ctypes.data, data.size,
                                       int(cd[0]) if len(cd) else 1,
                                       out.ctypes.data)
                data = out
            elif fid == _LZF:
                data = self._lzf(idx, data, cd, out)
            else:
                data = self._scaleoffset(idx, data, cd, out)
        if data.size != n:
            raise OSError(f"{self._label(idx)}: {data.size} bytes decoded "
                          f"where the chunk has {n}")
        if dst is not None and data.ctypes.data != dst.ctypes.data:
            dst[:] = data
            return dst
        return data.copy() if in_scratch else data

    def _scratch(self, k, n):
        """This thread's scratch buffer ``k`` (0 or 1), at least ``n``
        bytes: the filters between a chunk's stored bytes and its last
        step write there."""
        bufs = self._local.__dict__.setdefault("bufs", [None, None])
        if bufs[k] is None or bufs[k].size < n:
            bufs[k] = np.empty(n, np.uint8)
        return bufs[k]

    def _inflate(self, idx, data):
        """A zlib stream inflated (its output buffer sized for the chunk
        at once)."""
        try:
            return _u8(zlib.decompress(data, 15, self._chunk_bytes))
        except zlib.error as e:
            raise OSError(f"{self._label(idx)}: corrupt deflate stream "
                          f"({e})") from None

    def _fletcher32(self, idx, data):
        buf = _u8(data)
        if buf.size < 4:
            raise OSError(f"{self._label(idx)}: {buf.size} bytes cannot "
                          "hold a Fletcher-32 checksum")
        body = np.ascontiguousarray(buf[:-4])
        stored = int.from_bytes(bytes(buf[-4:]), "little")
        got = int(_codec().h5c_fletcher32(body.ctypes.data, body.size))
        # HDF5 before 1.6.3 stored the sum with its 16-bit halves'
        # bytes swapped; HDF5 takes either
        swapped = ((got & 0x00FF00FF) << 8) | ((got >> 8) & 0x00FF00FF)
        if stored not in (got, swapped):
            raise OSError(f"{self._label(idx)}: Fletcher-32 checksum "
                          f"mismatch (stored {stored:#010x}, computed "
                          f"{got:#010x}): data error detected by fletcher32 "
                          "checksum")
        return body

    def _lzf(self, idx, src, cd, out):
        cap = max(int(cd[2]) if len(cd) > 2 else 0, self._chunk_bytes)
        buf = out
        while True:
            got = int(_codec().h5c_lzf_decode(src.ctypes.data, src.size,
                                               buf.ctypes.data, buf.size))
            if got != -5 or cap > 1 << 31:
                break
            cap = max(cap, buf.size) * 2
            buf = np.empty(cap, np.uint8)
        if got < 0:
            raise OSError(f"{self._label(idx)}: corrupt LZF stream "
                          f"(status {got})")
        return buf[:got]

    def _scaleoffset(self, idx, src, cd, out):
        out = out[:self._chunk_bytes]
        cd = np.ascontiguousarray(cd, np.uint32)
        status = _codec().h5c_scaleoffset_decode(
            src.ctypes.data, src.size, out.ctypes.data, out.size,
            cd.ctypes.data, cd.size)
        if status:
            raise OSError(f"{self._label(idx)}: corrupt scale-offset data "
                          f"(status {status})")
        return out

    # -- reads
    def read(self, lo, hi, dtype=np.float32):
        """Elements ``[lo, hi)`` of the leading axis, every other axis
        whole, as ``dtype``."""
        lo, hi = max(0, int(lo)), min(int(hi), self.shape[0])
        out = np.empty((max(0, hi - lo), *self.shape[1:]), dtype)
        if hi <= lo:
            return out
        if self.layout == "compact":
            out[...] = self._compact[lo:hi]
        elif self.layout == "contiguous":
            self._read_contiguous(lo, hi, out)
        else:
            self._read_chunked(lo, hi, out)
        return out

    def _read_contiguous(self, lo, hi, out):
        if not self._f.defined(self._addr):
            out[...] = self.fill_value
            return
        frame = math.prod(self.shape[1:]) * self.dtype.itemsize
        same = out.dtype == self.dtype
        # pieces of at least 8 MB on the pool
        step = max(1, (8 << 20) // max(frame, 1))
        starts = list(range(lo, hi, step))

        def piece(a):
            b = min(a + step, hi)
            dst = out[a - lo:b - lo]
            if same:
                self._f.read_into(self._addr + a * frame, dst)
            else:
                dst[...] = np.frombuffer(self._f.read(
                    self._addr + a * frame, (b - a) * frame),
                    self.dtype).reshape(dst.shape)
        pool_map(piece, starts)

    def _read_chunked(self, lo, hi, out):
        index = self._chunk_index()
        c0 = self.chunks[0]
        idxs = [(i0, *r) for i0 in range(lo // c0, (hi - 1) // c0 + 1)
                for r in np.ndindex(*self.grid[1:])]
        direct_ok = (out.dtype == self.dtype
                     and self.chunks[1:] == self.shape[1:])

        def slot(idx):
            i0 = idx[0]
            if direct_ok and i0 * c0 >= lo and (i0 + 1) * c0 <= hi:
                return out[i0 * c0 - lo:(i0 + 1) * c0 - lo]
            return None

        todo = []
        with self._lock:
            for idx in idxs:
                hit = self._cache.get(idx)
                if hit is not None and slot(idx) is None:
                    self._cache.move_to_end(idx)
                    self._place(out, lo, idx, hit)
                else:
                    todo.append(idx)

        def one(idx):
            entry = index.get(idx)
            if entry is None:
                self._place(out, lo, idx, None)
                return
            addr, size, mask = entry
            dst = slot(idx)
            if dst is not None and not self.filters:
                self._f.read_into(addr, dst)
                return
            raw = self._f.read(addr, size)
            got = self._decode(idx, raw, mask,
                               None if dst is None else
                               dst.reshape(-1).view(np.uint8))
            if dst is None:
                chunk = got.view(self.dtype).reshape(self.chunks)
                self._place(out, lo, idx, chunk)
                self._keep(idx, chunk)

        pool_map(one, todo)

    def _keep(self, idx, chunk):
        if chunk.nbytes > CHUNK_CACHE_BYTES:
            return
        with self._lock:
            if idx in self._cache:
                return
            self._cache[idx] = chunk
            self._cache_bytes += chunk.nbytes
            while self._cache_bytes > CHUNK_CACHE_BYTES:
                _, old = self._cache.popitem(last=False)
                self._cache_bytes -= old.nbytes

    def _place(self, out, lo, idx, chunk):
        """Copy the part of the chunk (None: the fill value) inside the
        dataset and the range into ``out``."""
        start = [i * c for i, c in zip(idx, self.chunks)]
        ext = [min(c, s - a) for a, c, s in zip(start, self.chunks,
                                                 self.shape)]
        a0 = max(start[0], lo)
        b0 = min(start[0] + ext[0], lo + out.shape[0])
        dst = (slice(a0 - lo, b0 - lo),) + tuple(
            slice(s, s + e) for s, e in zip(start[1:], ext[1:]))
        if chunk is None:
            out[dst] = self.fill_value
            return
        out[dst] = chunk[(slice(a0 - start[0], b0 - start[0]),) + tuple(
            slice(0, e) for e in ext[1:])]

    # -- h5py's indexing
    def take(self, key, dtype=np.float32):
        """``np.asarray(h5py_dataset[key], dtype)`` for ints, slices (step
        at least 1) and tuples of them, with h5py's errors."""
        key = key if isinstance(key, tuple) else (key,)
        if any(k is Ellipsis for k in key):
            i = next(i for i, k in enumerate(key) if k is Ellipsis)
            fill = (slice(None),) * (self.ndim - len(key) + 1)
            key = key[:i] + fill + key[i + 1:]
        if len(key) > self.ndim:
            raise ValueError(f"{len(key)} indexing arguments for "
                             f"{self.ndim} dimensions")
        key = key + (slice(None),) * (self.ndim - len(key))
        norm = []
        for k, n in zip(key, self.shape):
            if isinstance(k, slice):
                if k.step is not None and k.step < 1:
                    raise ValueError(f"Step must be >= 1 (got {k.step})")
                a, b, s = k.indices(n)
                norm.append(slice(a, max(a, b), s))
            elif isinstance(k, (int, np.integer)):
                i = int(k) + (n if k < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"Index ({i}) out of range for "
                                     f"(0-{n - 1})")
                norm.append(i)
            else:
                raise TypeError(f"an HDF5 dataset is indexed here by ints, "
                                f"slices and tuples of them, not "
                                f"{type(k).__name__}")
        first = norm[0]
        if isinstance(first, int):
            rows, sub = self.read(first, first + 1, dtype), 0
        else:
            rows = self.read(first.start, first.stop, dtype)
            sub = slice(None, None, first.step)
        got = np.asarray(rows[(sub, *norm[1:])])
        return got if got.flags.c_contiguous else np.ascontiguousarray(got)
