"""Zarr v2 / zarr v3 / n5 arrays in local directories (host NumPy, the
native codec and the standard library; no zarr library).

:class:`ZarrArray` reads every layout ``tensorstore``'s ``zarr``, ``zarr3``
and ``n5`` drivers write on a ``file`` kvstore, for integer, unsigned,
float and bool data:

- zarr v2: ``.zarray`` (``dtype``, ``chunks``, ``order`` C or F,
  ``dimension_separator``, ``fill_value``); compressor ``null``, ``zlib``,
  ``gzip``, ``bz2``, ``zstd`` or ``blosc`` (``cname`` blosclz, lz4, lz4hc,
  snappy, zlib or zstd; ``shuffle`` -1, 0, 1 or 2); no filters.
- zarr v3: ``zarr.json`` (regular chunk grid, the ``default`` and ``v2``
  chunk key encodings); codecs ``transpose`` (any order), then ``bytes``
  (either endian) or ``sharding_indexed`` (its inner codecs go through this
  same chain, so shards nest; its index codecs are ``bytes``, then
  optionally ``crc32c``; the index at the start or the end of the shard),
  then any of ``gzip``, ``blosc`` (any ``cname`` above; ``noshuffle``,
  ``shuffle`` or ``bitshuffle``), ``zstd`` (with or without checksum) and
  ``crc32c`` (verified: a mismatch raises, naming the chunk).
- n5: ``attributes.json``; each block a big-endian header (mode,
  dimensions, the block's own extent) over data in column-major order,
  big-endian; compression ``raw``, ``gzip`` (either container), ``bzip2``,
  ``xz``, ``zstd`` or ``blosc``.

Each format's metadata becomes one chain of codecs in encode order (array
-> array ``transpose``; one array -> bytes codec, ``bytes`` or
``sharding_indexed``; bytes -> bytes codecs), and every chunk decodes
through it: zarr v2's ``order`` F is a transpose and its compressor the one
bytes codec; an n5 block is its header, then the column-major transpose and
``compression``.

``read(lo, hi)`` returns the frames ``[lo, hi)`` of the leading axis:
chunk files are read on a pool of threads; the Blosc frames among them are
decoded together by one native call (every block of every frame one job on
8 threads), and so are the zstd frames (one job each); gzip, bz2 and xz
chunks decode on the pool.  A chunk that lies wholly inside the range in
the output's own layout is decoded (or, uncompressed, read) straight into
the output.  A chunk file that does not exist, and an inner chunk that its
shard's index marks absent, read as the fill value.  In a sharded array the
unit of a read is the inner chunk: a read reads each shard's index once,
then only the byte ranges of the inner chunks it needs.

Libraries: the native codec ``io/native/zarrcodec.cpp`` (built with ``g++``
with the text decoders) decodes Blosc frames (BloscLZ, LZ4 and Snappy
itself, no libsnappy loaded; zlib and zstd through ``libz.so.1`` and
``libzstd.so.1``, loaded at first use), standalone zstd frames
(``libzstd.so.1``) and crc32c; Python's ``zlib``,
``bz2`` and ``lzma`` decode gzip/zlib, bz2 and xz.  A layout this reader
does not decode, or a codec whose library is not usable here, raises
:class:`UnsupportedLayout` (a ``ValueError`` naming it) when the array is
opened, never part way through a read; there is no Python fallback for the
native codec.

:class:`ZarrWriter` writes what :func:`zarr_metadata` describes — the
metadata ``tensorstore`` writes for ``convert_to_zarr`` (zarr v2 with the
blosc/LZ4 compressor, or zarr v3 with the raw ``bytes`` codec), as the same
JSON — in chunks of whole leading-axis slabs, an edge chunk at the full
chunk size.  The Blosc frames the native encoder writes may differ from
another encoder's bytes; they decode to the same arrays.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sitator_tpu_torch.io._shared import (N_THREADS, library_usable,
                                          native_lib, pool_map)

__all__ = ["ZarrArray", "ZarrWriter", "zarr_metadata", "store_format",
           "UnsupportedLayout", "codec_libraries", "blosc_decode",
           "blosc_encode", "zstd_decode", "snappy_decode", "crc32c"]

BLOSC_COMPRESSORS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib",
                     4: "zstd"}
# the Blosc cnames this reader decodes, each with the library it loads
BLOSC_CNAMES = {"blosclz": None, "lz4": None, "lz4hc": None, "snappy": None,
                "zlib": "libz.so.1", "zstd": "libzstd.so.1"}
_STREAM = {"blosclz": "BloscLZ", "lz4": "LZ4", "snappy": "Snappy",
           "zlib": "zlib", "zstd": "zstd"}
_STATUS = {-1: "truncated Blosc frame",
           -2: "unsupported Blosc frame version",
           -5: "Blosc frame of another size than the chunk",
           -7: "malformed Blosc frame"}
_METADATA = {"zarr": ".zarray", "zarr3": "zarr.json", "n5": "attributes.json"}
# each format's bytes -> bytes codecs: its name -> the codec
_BYTES_CODECS = {
    "zarr": {"zlib": "gzip", "gzip": "gzip", "bz2": "bz2", "zstd": "zstd",
             "blosc": "blosc"},
    "zarr3": {"gzip": "gzip", "blosc": "blosc", "zstd": "zstd",
              "crc32c": "crc32c"},
    "n5": {"gzip": "gzip", "bzip2": "bz2", "xz": "xz", "zstd": "zstd",
           "blosc": "blosc"}}
# what each codec needs at run time besides numpy
_NEEDS = {"gzip": (), "bz2": ("bz2",), "xz": ("lzma",),
          "zstd": ("zarrcodec", "libzstd.so.1"), "crc32c": ("zarrcodec",),
          "blosc": ("zarrcodec",)}
LIBRARIES = {"zarrcodec": "the native codec (io/native/zarrcodec.cpp, "
                          "built with g++)",
             "libz.so.1": "libz.so.1", "libzstd.so.1": "libzstd.so.1",
             "bz2": "Python's bz2 module", "lzma": "Python's lzma module"}
_ABSENT = 2 ** 64 - 1             # a shard index entry of an absent chunk


class UnsupportedLayout(ValueError):
    """A store layout or codec this reader does not decode here: one it
    does not implement, or one whose library is not usable.  Raised when
    the array is opened."""


def store_format(path):
    """``'zarr3'``, ``'zarr'`` or ``'n5'`` for the metadata file in the
    directory ``path`` (in that order of precedence), else None."""
    for fmt in ("zarr3", "zarr", "n5"):
        if os.path.exists(os.path.join(path, _METADATA[fmt])):
            return fmt
    return None


# ------------------------------------------------------------------ codec
def _codec():
    lib = native_lib()
    if lib is None:
        raise RuntimeError(
            "Blosc, zstd and crc32c need the native codec "
            "(sitator_tpu_torch/io/native/zarrcodec.cpp), which is built "
            "with g++ at first use; g++ is not usable here")
    return lib


def codec_libraries():
    """``{library: usable here}`` for every library a codec may need."""
    return {name: library_usable(name) for name in LIBRARIES}


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data for a in arrays])


def _frame_error(frame, status):
    code = (int(frame[2]) >> 5) & 7 if frame.size > 2 else None
    name = BLOSC_COMPRESSORS.get(code, f"code {code}")
    if status == -3:
        return ValueError(
            f"Blosc compressor {name!r} is not supported (the codec "
            "decodes blosclz, lz4, lz4hc, snappy, zlib and zstd frames)")
    if status == -6:
        return ValueError(f"corrupt {_STREAM.get(name, name)} stream in a "
                          "Blosc frame")
    if status == -8:
        return ValueError(f"a Blosc frame compressed with {name!r} needs "
                          f"{BLOSC_CNAMES[name]}, which does not load here")
    return ValueError(_STATUS.get(status, f"Blosc status {status}"))


def _batch(fn, frames, outs):
    """One native batch call over (frame, out) pairs: the status of each."""
    n = len(frames)
    status = np.zeros(n, np.int32)
    fn(n, _ptrs(frames), (ctypes.c_int64 * n)(*[f.size for f in frames]),
       _ptrs(outs), (ctypes.c_int64 * n)(*[o.size for o in outs]),
       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), N_THREADS)
    return status


def _uint8(arrays):
    return [np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
            for a in arrays]


def blosc_decode(frames, outs, labels=None):
    """Decode each Blosc frame (a uint8 array) into the matching writable
    C-contiguous array of ``outs``, whose size must be the frame's decoded
    size.  All frames in one native call on :data:`N_THREADS` threads;
    raises ``ValueError`` naming the first frame's fault (and its label,
    where ``labels`` gives one per frame)."""
    if not frames:
        return
    src = _uint8(frames)
    status = _batch(_codec().zc_blosc_decode, src,
                    [o.reshape(-1).view(np.uint8) for o in outs])
    if status.any():
        i = int(np.flatnonzero(status)[0])
        err = _frame_error(src[i], int(status[i]))
        raise ValueError(f"{labels[i]}: {err}") if labels else err


def zstd_decode(frames, outs, labels=None):
    """Decode each zstd frame into the matching writable C-contiguous
    array of ``outs``, whose size must be the frame's decoded size; one
    native call, a frame a job on :data:`N_THREADS` threads."""
    if not frames:
        return
    src = _uint8(frames)
    status = _batch(_codec().zc_zstd_decode, src,
                    [o.reshape(-1).view(np.uint8) for o in outs])
    if status.any():
        i = int(np.flatnonzero(status)[0])
        err = {-5: "a zstd frame of another size than the chunk",
               -6: "corrupt zstd frame",
               -8: "zstd needs libzstd.so.1, which does not load here"}.get(
            int(status[i]), f"zstd status {status[i]}")
        raise ValueError(f"{labels[i]}: {err}" if labels else err)


def crc32c(data):
    """CRC-32C (Castagnoli) of a bytes-like object or uint8 array."""
    buf = (np.ascontiguousarray(data).reshape(-1).view(np.uint8)
           if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8))
    return int(_codec().zc_crc32c(buf.ctypes.data, buf.size))


def snappy_decode(data, n):
    """A raw Snappy stream (``bytes`` or a uint8 array) decoded into ``n``
    bytes of room: the decoded bytes; ``ValueError`` for a corrupt or
    truncated stream."""
    src = _uint8([data if isinstance(data, np.ndarray)
                  else np.frombuffer(data, np.uint8)])[0]
    out = np.empty(max(int(n), 1), np.uint8)
    got = int(_codec().zc_snappy_decode(src.ctypes.data, src.size,
                                         out.ctypes.data, int(n)))
    if got < 0:
        raise ValueError(f"corrupt Snappy stream (status {got})")
    return out[:got].tobytes()


def blosc_encode(arrays, clevel=5, shuffle=True):
    """Blosc frames (``bytes``) of the C-contiguous arrays, LZ4 at
    ``clevel`` with byte shuffle over each array's item size."""
    if not arrays:
        return []
    lib = _codec()
    src = [np.ascontiguousarray(a) for a in arrays]
    n = len(src)
    typesize = src[0].dtype.itemsize
    nbytes = [a.nbytes for a in src]
    dst = [np.empty(b + 16, np.uint8) for b in nbytes]
    out_len = np.zeros(n, np.int64)
    rc = lib.zc_blosc_encode(
        n, _ptrs(src), (ctypes.c_int64 * n)(*nbytes), typesize, int(clevel),
        int(bool(shuffle)), _ptrs(dst),
        (ctypes.c_int64 * n)(*[d.size for d in dst]),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), N_THREADS)
    if rc != 0:
        raise RuntimeError(f"Blosc encode failed with status {rc}")
    return [d[:int(k)].tobytes() for d, k in zip(dst, out_len)]


# ------------------------------------------------------------- codec chain
def _stated_size(name, data, label):
    """The decoded size a Blosc or zstd frame states in its header."""
    if name == "blosc":
        return int(data[4:8].view("<u4")[0]) if data.size >= 16 else 0
    size = int(_codec().zc_zstd_content_size(data.ctypes.data, data.size))
    if size < 0:
        raise ValueError(f"{label}: a zstd frame that states no decoded "
                         "size, inside a chain of codecs")
    return size


def _check_crc32c(data, label):
    if data.size < 4:
        raise ValueError(f"{label}: {data.size} bytes cannot hold a crc32c")
    want = int(data[-4:].view("<u4")[0])
    got = crc32c(data[:-4])
    if got != want:
        raise ValueError(f"{label}: crc32c mismatch (stored {want:#010x}, "
                         f"computed {got:#010x})")
    return data[:-4]


def _inflate(name):
    if name == "gzip":
        return lambda d: zlib.decompress(d, 47), zlib.error
    if name == "bz2":
        import bz2
        return bz2.decompress, OSError
    import lzma
    return lzma.decompress, lzma.LZMAError


def _decode_bytes(name, datas, sizes, outs, labels):
    """One bytes -> bytes codec undone over a batch: ``datas`` (uint8
    arrays), the decoded size of each (None: not known ahead), an array to
    decode into (or None) each.  Returns the decoded uint8 arrays."""
    outs = [None if o is None else o.reshape(-1).view(np.uint8)
            for o in outs]
    if name == "crc32c":
        got = pool_map(_check_crc32c, datas, labels)
    elif name in ("blosc", "zstd"):
        outs = [o if o is not None else
                np.empty(s if s is not None else
                         _stated_size(name, d, label), np.uint8)
                for d, s, o, label in zip(datas, sizes, outs, labels)]
        (blosc_decode if name == "blosc" else zstd_decode)(
            datas, outs, labels)
        return outs
    else:
        fn, error = _inflate(name)

        def one(d, label):
            try:
                return np.frombuffer(fn(memoryview(d)), np.uint8)
            except (error, EOFError, ValueError) as e:
                raise ValueError(f"{label}: corrupt {name} data ({e})") \
                    from None
        got = pool_map(one, datas, labels)
    for i, (g, s, o, label) in enumerate(zip(got, sizes, outs, labels)):
        if s is not None and g.size != s:
            raise ValueError(f"{label}: {g.size} bytes where the chunk has "
                             f"{s}")
        if o is not None:
            o[:] = g
            got[i] = o
    return got


class _Chain:
    """The codecs of an array, or of a shard's inner chunks, in encode
    order: the permutations of its ``transpose`` codecs (``aa``), one array
    -> bytes codec (``ab``: the stored dtype for ``bytes``, or a
    :class:`_Shard`) and its bytes -> bytes codecs (``bb``: (codec,
    configuration) pairs)."""

    def __init__(self, aa, ab, bb):
        self.aa, self.ab, self.bb = aa, ab, bb

    def needs(self):
        """(codec, library) of every library the chain's codecs load."""
        for name, cfg in self.bb:
            for lib in _NEEDS[name]:
                yield name, lib
            if name == "blosc" and BLOSC_CNAMES[cfg.get("cname", "lz4")]:
                yield f"blosc/{cfg['cname']}", BLOSC_CNAMES[cfg["cname"]]
        if isinstance(self.ab, _Shard):
            yield from self.ab.inner.needs()
            yield from self.ab.index.needs()

    def direct(self, dtype):
        """Whether a chunk decodes straight into a C-ordered array of
        ``dtype``."""
        return (not self.aa and isinstance(self.ab, np.dtype)
                and self.ab == np.dtype(dtype))

    def decode(self, blobs, shapes, labels, outs=None):
        """Each blob (uint8) decoded to an array of its shape.  Where
        ``outs`` gives an array (the chain :meth:`direct` for its dtype,
        with bytes -> bytes codecs) the chunk is decoded into it."""
        n = len(blobs)
        outs = outs or [None] * n
        eshapes = []
        for shape in shapes:
            for order in self.aa:
                shape = tuple(shape[o] for o in order)
            eshapes.append(tuple(shape))
        shard = isinstance(self.ab, _Shard)
        data = list(blobs)
        for k, (name, _) in enumerate(reversed(self.bb)):
            last = k == len(self.bb) - 1
            sizes = [None if shard or not last else
                     math.prod(e) * self.ab.itemsize for e in eshapes]
            data = _decode_bytes(name, data, sizes,
                                 outs if last else [None] * n, labels)
        if shard:
            arrays = [self.ab.decode(d, e, label)
                      for d, e, label in zip(data, eshapes, labels)]
        else:
            arrays = []
            for d, e, label in zip(data, eshapes, labels):
                if d.size != math.prod(e) * self.ab.itemsize:
                    raise ValueError(f"{label}: {d.size} bytes for a chunk "
                                     f"of {e} {self.ab}")
                arrays.append(d.view(self.ab).reshape(e))
        for order in reversed(self.aa):
            inverse = tuple(int(i) for i in np.argsort(order))
            arrays = [a.transpose(inverse) for a in arrays]
        return arrays


class _Shard:
    """A ``sharding_indexed`` codec: a shard of ``shape`` holds inner
    chunks of ``chunk_shape`` (a grid ``grid``), each encoded by the chain
    ``inner``; its index, one (offset, size) uint64 pair per inner chunk in
    C order, is encoded by the chain ``index`` at the ``start`` or end of
    the shard."""

    def __init__(self, shape, chunk_shape, inner, index, at_start, dtype,
                 fill_value):
        self.chunk_shape = tuple(int(c) for c in chunk_shape)
        self.grid = tuple(s // c for s, c in zip(shape, self.chunk_shape))
        self.inner, self.index, self.at_start = inner, index, at_start
        self.dtype, self.fill_value = dtype, fill_value
        self.index_nbytes = 16 * math.prod(self.grid) + 4 * sum(
            name == "crc32c" for name, _ in index.bb)

    def entries(self, raws, labels):
        """The index of each shard (its raw index bytes) as (n, 2)."""
        got = self.index.decode(raws, [(*self.grid, 2)] * len(raws), labels)
        return [e.reshape(-1, 2) for e in got]

    @staticmethod
    def locate(entries, k, size, label):
        """(offset, size) of inner chunk ``k`` in a shard of ``size``
        bytes, None if the index marks it absent."""
        off, nbytes = (int(x) for x in entries[k])
        if off == nbytes == _ABSENT:
            return None
        if off + nbytes > size:
            raise ValueError(f"{label}: inner chunk {k} at bytes [{off}, "
                             f"{off + nbytes}) lies past the end of the "
                             f"{size}-byte shard")
        return off, nbytes

    def decode(self, blob, shape, label):
        """A whole shard (nested in another's inner chunk) from its
        bytes."""
        m = self.index_nbytes
        if blob.size < m:
            raise ValueError(f"{label}: a shard of {blob.size} bytes cannot "
                             f"hold its {m}-byte index")
        raw = blob[:m] if self.at_start else blob[blob.size - m:]
        entries = self.entries([raw], [f"{label} (shard index)"])[0]
        out = np.full(shape, self.fill_value, self.dtype)
        where = [(k, self.locate(entries, k, blob.size, label))
                 for k in range(len(entries))]
        where = [(k, loc) for k, loc in where if loc is not None]
        arrays = self.inner.decode(
            [blob[o:o + n] for _, (o, n) in where],
            [self.chunk_shape] * len(where),
            [f"{label} inner chunk {k}" for k, _ in where])
        for (k, _), a in zip(where, arrays):
            pos = np.unravel_index(k, self.grid)
            out[tuple(slice(p * c, (p + 1) * c)
                      for p, c in zip(pos, self.chunk_shape))] = a
        return out


# ---------------------------------------------------------------- metadata
def _v3_fill(value, dtype):
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise UnsupportedLayout(f"zarr v3 fill_value {value!r} is not "
                                    "supported")
        value = special[value]
    return dtype.type(value)


def _dtype(name, where):
    try:
        dt = np.dtype(name)
    except TypeError:
        raise UnsupportedLayout(f"{where} data type {name!r} is not "
                                "supported") from None
    if dt.kind not in "fiub":
        raise UnsupportedLayout(f"{where} data type {name!r} is not "
                                "supported")
    return dt


def _transpose_order(order, ndim):
    if order in ("C", "F"):
        return tuple(range(ndim))[::-1 if order == "F" else 1]
    order = tuple(int(o) for o in order)
    if sorted(order) != list(range(ndim)):
        raise UnsupportedLayout(f"zarr v3 transpose order {list(order)} is "
                                f"not a permutation of {ndim} axes")
    return order


class ZarrArray:
    """A zarr v2, zarr v3 or n5 array in the directory ``path``.

    Attributes: ``format`` (``'zarr'``, ``'zarr3'``, ``'n5'``), ``shape``,
    ``chunks`` (of the chunk grid: a shard, in a sharded array), ``grid``,
    ``dtype`` (as stored, with its byte order), ``fill_value``,
    ``metadata`` (the parsed metadata file).  Raises
    :class:`UnsupportedLayout` for a layout it does not decode here.
    """

    def __init__(self, path, fmt=None):
        self.path = os.fspath(path)
        self.format = fmt or store_format(self.path)
        if self.format is None:
            raise ValueError(f"{self.path} is not a zarr/zarr3/n5 array "
                             "store")
        with open(os.path.join(self.path, _METADATA[self.format])) as f:
            self.metadata = m = json.load(f)
        self._cache_lock = threading.Lock()
        self._cache = None            # (unit index, decoded unit)
        getattr(self, f"_parse_{self.format}")(m)
        self.ndim = len(self.shape)
        if len(self.chunks) != self.ndim or min(self.chunks, default=1) < 1:
            raise ValueError(f"{self.path}: chunk shape {self.chunks} does "
                             f"not fit the array shape {self.shape}")
        self.grid = tuple(math.ceil(s / c) if s else 0
                          for s, c in zip(self.shape, self.chunks))
        for codec, lib in self._chain.needs():
            if not library_usable(lib):
                raise UnsupportedLayout(
                    f"{self.path}: the {self.format} codec {codec!r} needs "
                    f"{LIBRARIES[lib]}, which is not usable here")
        # the unit of a read: a sharded array's inner chunk, when the
        # shard is the chain's only codec; else the chunk
        ab = self._chain.ab
        self._shard = ab if (isinstance(ab, _Shard) and not self._chain.aa
                             and not self._chain.bb) else None
        self._unit = self._shard.chunk_shape if self._shard else self.chunks
        self._unit_chain = self._shard.inner if self._shard else self._chain
        self._unit_grid = tuple(math.ceil(s / c) if s else 0
                                for s, c in zip(self.shape, self._unit))

    # -- metadata of each format
    def _parse_zarr(self, m):
        if m.get("zarr_format") != 2:
            raise ValueError(f"{self.path}: .zarray zarr_format "
                             f"{m.get('zarr_format')!r}")
        self._set_shape(m["shape"], m["chunks"])
        self.dtype = _dtype(m["dtype"], "zarr v2")
        if m.get("filters"):
            raise UnsupportedLayout(
                "zarr v2 filters are not supported: " + ", ".join(
                    repr(f.get("id")) for f in m["filters"]))
        comp = m.get("compressor")
        bb = [] if comp is None else [self._bytes_codec(
            comp.get("id"), comp, "zarr v2 compressor")]
        order = m.get("order", "C")
        if order not in ("C", "F"):
            raise UnsupportedLayout(f"zarr v2 order {order!r}")
        self._chain = _Chain([_transpose_order("F", len(self.shape))]
                             if order == "F" else [], self.dtype, bb)
        fill = m.get("fill_value")
        self.fill_value = self.dtype.type(0 if fill is None else (
            {"NaN": np.nan, "Infinity": np.inf,
             "-Infinity": -np.inf}.get(fill, fill)))
        sep = m.get("dimension_separator", ".")
        self._key = lambda idx: sep.join(map(str, idx)) if idx else "0"

    def _parse_zarr3(self, m):
        if m.get("zarr_format") != 3 or m.get("node_type") != "array":
            raise ValueError(f"{self.path}: zarr.json is not a zarr v3 "
                             "array")
        grid = m["chunk_grid"]
        if grid.get("name") != "regular":
            raise UnsupportedLayout(f"zarr v3 chunk grid {grid.get('name')!r}"
                                    " is not supported (regular is)")
        self._set_shape(m["shape"], grid["configuration"]["chunk_shape"])
        if m.get("storage_transformers"):
            raise UnsupportedLayout(
                "zarr v3 storage transformers are not supported: " + ", ".join(
                    repr(t.get("name")) for t in m["storage_transformers"]))
        dtype = _dtype(m["data_type"], "zarr v3")
        self.fill_value = _v3_fill(m.get("fill_value", 0), dtype)
        self._chain = self._v3_chain(m["codecs"], self.chunks, dtype)
        ab = self._chain.ab
        while isinstance(ab, _Shard):
            ab = ab.inner.ab
        self.dtype = ab               # the innermost bytes codec's order
        enc = m.get("chunk_key_encoding", {"name": "default"})
        sep = (enc.get("configuration") or {}).get(
            "separator", "/" if enc.get("name") == "default" else ".")
        if enc.get("name") == "default":
            self._key = lambda idx: sep.join(["c", *map(str, idx)])
        elif enc.get("name") == "v2":
            self._key = lambda idx: sep.join(map(str, idx)) if idx else "0"
        else:
            raise UnsupportedLayout(f"zarr v3 chunk key encoding "
                                    f"{enc.get('name')!r} is not supported")

    def _v3_chain(self, codecs, shape, dtype):
        """The chain of a zarr v3 codec list for chunks of ``shape``."""
        aa, ab, bb = [], None, []
        for c in codecs:
            name, cfg = c.get("name"), c.get("configuration") or {}
            if ab is not None:
                bb.append(self._bytes_codec(name, cfg, "zarr v3 codec"))
            elif name == "transpose":
                aa.append(_transpose_order(cfg.get("order"), len(shape)))
                shape = tuple(shape[o] for o in aa[-1])
            elif name == "bytes":
                ab = dtype.newbyteorder(
                    ">" if cfg.get("endian", "little") == "big" else "<")
            elif name == "sharding_indexed":
                ab = self._sharding(cfg, shape, dtype)
            else:
                raise UnsupportedLayout(
                    f"zarr v3 codec {name!r} is not supported (transpose, "
                    "then bytes or sharding_indexed, then gzip, blosc, zstd "
                    "or crc32c are)")
        if ab is None:
            raise UnsupportedLayout("zarr v3 codecs without bytes or "
                                    "sharding_indexed are not supported")
        return _Chain(aa, ab, bb)

    def _sharding(self, cfg, shape, dtype):
        inner_shape = tuple(int(c) for c in cfg["chunk_shape"])
        if len(inner_shape) != len(shape) or min(inner_shape) < 1 or any(
                s % c for s, c in zip(shape, inner_shape)):
            raise UnsupportedLayout(
                f"zarr v3 sharding_indexed chunk_shape {list(inner_shape)} "
                f"does not divide the shard {list(shape)}")
        grid = tuple(s // c for s, c in zip(shape, inner_shape))
        index = self._v3_chain(cfg["index_codecs"], (*grid, 2),
                               np.dtype(np.uint64))
        if index.aa or isinstance(index.ab, _Shard) or any(
                name != "crc32c" for name, _ in index.bb):
            raise UnsupportedLayout(
                "zarr v3 sharding_indexed index_codecs "
                f"{[c.get('name') for c in cfg['index_codecs']]} are not "
                "supported (bytes, then optionally crc32c, are)")
        location = cfg.get("index_location", "end")
        if location not in ("start", "end"):
            raise UnsupportedLayout(f"zarr v3 sharding_indexed "
                                    f"index_location {location!r}")
        return _Shard(shape, inner_shape,
                      self._v3_chain(cfg["codecs"], inner_shape, dtype),
                      index, location == "start", dtype, self.fill_value)

    def _parse_n5(self, m):
        self._set_shape(m["dimensions"], m["blockSize"])
        self.dtype = _dtype(m["dataType"], "n5").newbyteorder(">")
        comp = m.get("compression", {"type": "raw"})
        bb = [] if comp.get("type") == "raw" else [self._bytes_codec(
            comp.get("type"), comp, "n5 compression")]
        self._chain = _Chain([_transpose_order("F", len(self.shape))],
                             self.dtype, bb)
        self.fill_value = self.dtype.type(0)
        self._key = lambda idx: "/".join(map(str, idx)) if idx else "0"

    def _set_shape(self, shape, chunks):
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)

    def _bytes_codec(self, name, config, where):
        codecs = _BYTES_CODECS[self.format]
        if name not in codecs:
            raise UnsupportedLayout(
                f"{where} {name!r} is not supported (raw, "
                + ", ".join(codecs) + " are)")
        cname = config.get("cname", "lz4")
        if codecs[name] == "blosc" and cname not in BLOSC_CNAMES:
            raise UnsupportedLayout(
                f"{where} blosc with the Blosc compressor {cname!r} is not "
                "supported (" + ", ".join(BLOSC_CNAMES) + " are)")
        return codecs[name], config

    # -- chunks
    def chunk_path(self, idx):
        """The file of chunk ``idx`` of the chunk grid (a shard's)."""
        return os.path.join(self.path, *self._key(idx).split("/"))

    def _read_range(self, path, offset, size, into=None):
        """``size`` bytes at ``offset`` of the file (offset None: the whole
        file; None if there is no such file) as a uint8 array; with ``into``
        (a uint8 view of exactly that size) read straight into it."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            if offset is None:
                return None
            raise
        with f:
            if offset is None:
                size = os.fstat(f.fileno()).st_size
            else:
                f.seek(offset)
            buf = into if into is not None and into.size == size else \
                np.empty(size, np.uint8)
            got = f.readinto(memoryview(buf))
            if got != size:
                raise OSError(f"{path}: short read ({got} of {size} bytes)")
        return buf

    def _read_index(self, shard):
        """(raw index bytes, file size) of a shard file, None if there is
        no such file."""
        path = self.chunk_path(shard)
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return None
        m = self._shard.index_nbytes
        with f:
            size = os.fstat(f.fileno()).st_size
            if size < m:
                raise ValueError(f"{path}: a shard of {size} bytes cannot "
                                 f"hold its {m}-byte index")
            f.seek(0 if self._shard.at_start else size - m)
            raw = np.frombuffer(f.read(m), np.uint8)
        return raw, size

    def _locate(self, idxs):
        """Where each unit's bytes lie: (label, path, offset, size), offset
        None for the whole file; None for an inner chunk its shard's index
        marks absent or whose shard file does not exist."""
        if self._shard is None:
            return [(p, p, None, None) for p in map(self.chunk_path, idxs)]
        per = self._shard.grid
        shard_of = [tuple(i // g for i, g in zip(idx, per)) for idx in idxs]
        shards = sorted(set(shard_of))
        found = [(s, r) for s, r in zip(shards, pool_map(self._read_index,
                                                      shards))
                 if r is not None]
        entries = self._shard.entries(
            [raw for _, (raw, _) in found],
            [f"{self.chunk_path(s)} (shard index)" for s, _ in found])
        index = {s: (e, size) for (s, (_, size)), e in zip(found, entries)}
        where = []
        for idx, s in zip(idxs, shard_of):
            if s not in index:
                where.append(None)
                continue
            path = self.chunk_path(s)
            k = int(np.ravel_multi_index(
                tuple(i % g for i, g in zip(idx, per)), per))
            loc = self._shard.locate(index[s][0], k, index[s][1], path)
            where.append(None if loc is None else
                         (f"{path} inner chunk {k}", path, *loc))
        return where

    def _payload(self, raw, path):
        """(payload bytes, the unit's stored extent) of one unit: n5 blocks
        carry their extent in a header."""
        if self.format != "n5":
            return raw, self._unit
        head = raw[:4].view(">u2")
        mode, nd = int(head[0]), int(head[1])
        if mode not in (0, 1):
            raise UnsupportedLayout(f"{path}: n5 block mode {mode} is not "
                                    "supported")
        ext = tuple(int(x) for x in raw[4:4 + 4 * nd].view(">u4"))
        off = 4 + 4 * nd + (4 if mode == 1 else 0)
        if len(ext) != self.ndim:
            raise ValueError(f"{path}: block of {len(ext)} dimensions in a "
                             f"{self.ndim}-d array")
        return raw[off:], ext

    def read(self, lo, hi, dtype=np.float32):
        """Elements ``[lo, hi)`` of the leading axis, every other axis whole,
        as ``dtype``."""
        lo, hi = max(0, int(lo)), min(int(hi), self.shape[0])
        out = np.empty((max(0, hi - lo), *self.shape[1:]), dtype)
        if hi <= lo:
            return out
        u0 = self._unit[0]
        idxs = [(i0, *r) for i0 in range(lo // u0, (hi - 1) // u0 + 1)
                for r in np.ndindex(*self._unit_grid[1:])]
        # the output's own layout: a unit wholly inside the range, spanning
        # every other axis, goes straight into the output
        chain = self._unit_chain
        direct_ok = chain.direct(dtype) and self._unit[1:] == self.shape[1:]
        plain = not chain.bb and self.format != "n5"

        def slot(idx):
            i0 = idx[0]
            if direct_ok and i0 * u0 >= lo and (i0 + 1) * u0 <= hi:
                return out[i0 * u0 - lo:(i0 + 1) * u0 - lo]
            return None

        # a unit read only in part is kept (the last one): strided reads of
        # single frames, as the streaming fit makes, decode each unit once
        with self._cache_lock:
            cached = self._cache
        if cached is not None and cached[0] in idxs and slot(cached[0]) is None:
            self._place(out, lo, cached[0], cached[1])
            idxs = [i for i in idxs if i != cached[0]]
        if not idxs:
            return out
        where = self._locate(idxs)

        def load(idx, loc):
            if loc is None:
                return None, False
            dst = slot(idx)
            into = dst.reshape(-1).view(np.uint8) if (
                dst is not None and plain) else None
            raw = self._read_range(*loc[1:], into)
            return raw, raw is not None and raw is into

        todo = []
        for idx, loc, (raw, in_place) in zip(idxs, where,
                                             pool_map(load, idxs, where)):
            if raw is None:
                self._place(out, lo, idx, None)
            elif not in_place:        # else read straight into the output
                payload, ext = self._payload(raw, loc[0])
                dst = slot(idx)
                todo.append((idx, payload, ext, loc[0], dst if (
                    dst is not None and ext == self._unit and chain.bb)
                    else None))
        if not todo:
            return out
        idxs, payloads, exts, labels, targets = zip(*todo)
        arrays = chain.decode(list(payloads), list(exts), list(labels),
                              list(targets))
        for idx, target, chunk in zip(idxs, targets, arrays):
            if target is None:
                self._place(out, lo, idx, chunk)
                with self._cache_lock:
                    self._cache = idx, chunk
        return out

    def _place(self, out, lo, idx, chunk):
        """Copy the part of the unit ``chunk`` (None: the fill value) inside
        the array and the range into ``out``."""
        start = [i * c for i, c in zip(idx, self._unit)]
        ext = tuple(min(c, s - a)
                    for a, c, s in zip(start, self._unit, self.shape))
        a0 = max(start[0], lo)
        b0 = min(start[0] + ext[0], lo + out.shape[0])
        dst = (slice(a0 - lo, b0 - lo),) + tuple(
            slice(s, s + e) for s, e in zip(start[1:], ext[1:]))
        if chunk is None:
            out[dst] = self.fill_value
            return
        if any(h < e for h, e in zip(chunk.shape, ext)):
            # an n5 block stored shorter than its grid cell
            ext = tuple(min(h, e) for h, e in zip(chunk.shape, ext))
            out[dst] = self.fill_value
            b0 = min(start[0] + ext[0], lo + out.shape[0])
            dst = (slice(a0 - lo, b0 - lo),) + tuple(
                slice(s, s + e) for s, e in zip(start[1:], ext[1:]))
        src = (slice(a0 - start[0], b0 - start[0]),) + tuple(
            slice(0, e) for e in ext[1:])
        out[dst] = chunk[src]


# ------------------------------------------------------------------ writer
def zarr_metadata(shape, dtype, chunks, zarr_format):
    """The metadata ``tensorstore`` writes for a new ``convert_to_zarr``
    store: zarr v2 with the blosc/LZ4 compressor (auto shuffle), or zarr v3
    with the little-endian ``bytes`` codec."""
    dt = np.dtype(dtype)
    shape, chunks = [int(s) for s in shape], [int(c) for c in chunks]
    if zarr_format == 3:
        return {"chunk_grid": {"configuration": {"chunk_shape": chunks},
                               "name": "regular"},
                "chunk_key_encoding": {"name": "default"},
                "codecs": [{"configuration": {"endian": "little"},
                            "name": "bytes"}],
                "data_type": dt.name, "fill_value": 0.0 if dt.kind == "f"
                else 0, "node_type": "array", "shape": shape,
                "zarr_format": 3}
    if zarr_format == 2:
        return {"chunks": chunks,
                "compressor": {"blocksize": 0, "clevel": 5, "cname": "lz4",
                               "id": "blosc", "shuffle": -1},
                "dimension_separator": ".",
                "dtype": dt.newbyteorder("<").str, "fill_value": None,
                "filters": None, "order": "C", "shape": shape,
                "zarr_format": 2}
    raise ValueError(f"zarr_format must be 2 or 3 (int); got "
                     f"{zarr_format!r}")


class ZarrWriter:
    """A new zarr v2 or v3 store at ``path`` (what was there is deleted),
    chunked along the leading axis only: ``chunks = (c0, *shape[1:])``.

    ``write(lo, data)`` encodes and writes the chunks of the frames
    ``data`` starting at ``lo`` (a multiple of ``c0``; the data ends on a
    chunk boundary or at the end of the array, where the edge chunk is
    padded with zeros to the full chunk size) and returns a future; the
    caller bounds how many are in flight.  ``close()`` waits for all.
    """

    def __init__(self, path, shape, dtype, chunk_frames, zarr_format):
        self.path = os.fspath(path)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype).newbyteorder("<")
        self.chunks = (int(chunk_frames), *self.shape[1:])
        self.zarr_format = zarr_format
        meta = zarr_metadata(self.shape, self.dtype, self.chunks,
                             zarr_format)
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
        os.makedirs(self.path)
        name = "zarr.json" if zarr_format == 3 else ".zarray"
        with open(os.path.join(self.path, name), "w") as f:
            f.write(json.dumps(meta, sort_keys=True, separators=(",", ":")))
        self._exec = ThreadPoolExecutor(1, thread_name_prefix="zarr-write")

    def _key(self, i0):
        rest = ["0"] * (len(self.shape) - 1)
        if self.zarr_format == 3:
            return os.path.join(self.path, "c", str(i0), *rest)
        return os.path.join(self.path, ".".join([str(i0), *rest]))

    def _write(self, lo, data):
        c0 = self.chunks[0]
        chunks = []
        for a in range(0, len(data), c0):
            part = np.ascontiguousarray(data[a:a + c0], dtype=self.dtype)
            if len(part) < c0:
                pad = np.zeros(self.chunks, self.dtype)
                pad[:len(part)] = part
                part = pad
            chunks.append(part)
        if self.zarr_format == 3:
            encoded = [c.tobytes() for c in chunks]
        else:
            encoded = blosc_encode(chunks, clevel=5, shuffle=True)
        for k, blob in enumerate(encoded):
            p = self._key(lo // c0 + k)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(blob)

    def write(self, lo, data):
        c0 = self.chunks[0]
        lo = int(lo)
        if lo % c0 or (lo + len(data) != self.shape[0] and len(data) % c0):
            raise ValueError(f"writes are whole chunks of {c0} frames "
                             f"(lo={lo}, {len(data)} frames)")
        return self._exec.submit(self._write, lo, data)

    def close(self):
        self._exec.shutdown(wait=True)
