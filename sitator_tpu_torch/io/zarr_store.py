"""Zarr v2 / zarr v3 / n5 arrays in local directories (host NumPy and the
native Blosc codec; no zarr library).

:class:`ZarrArray` reads the three layouts ``tensorstore``'s ``zarr``,
``zarr3`` and ``n5`` drivers keep on a ``file`` kvstore:

- zarr v2: ``.zarray`` (``dtype``, ``chunks``, ``order`` C or F,
  ``dimension_separator``, ``fill_value``); compressor ``null``, ``blosc``
  (LZ4, byte shuffle or none), ``zlib`` or ``gzip``; no filters.
- zarr v3: ``zarr.json`` (regular chunk grid, the ``default`` and ``v2``
  chunk key encodings); the ``bytes`` codec (either endian), then
  optionally ``gzip`` or ``blosc``.  Sharding and any other codec raise a
  ``ValueError`` naming it.
- n5: ``attributes.json``; each block a big-endian header (mode,
  dimensions, the block's own extent) over data in column-major order,
  big-endian; compression ``raw``, ``gzip`` (either container) or
  ``blosc``.

``read(lo, hi)`` returns the frames ``[lo, hi)`` of the leading axis:
chunk files are read on a pool of threads and the Blosc chunks among them
decoded together by ``zarrcodec.cpp`` (every block of every chunk one job
on 8 threads); a chunk that lies wholly inside the range in the output's
own layout is decoded (or, uncompressed, read) straight into the output.
A chunk file that does not exist reads as the fill value.

:class:`ZarrWriter` writes what :func:`zarr_metadata` describes — the
metadata ``tensorstore`` writes for ``convert_to_zarr`` (zarr v2 with the
blosc/LZ4 compressor, or zarr v3 with the raw ``bytes`` codec), as the same
JSON — in chunks of whole leading-axis slabs, an edge chunk at the full
chunk size.  The Blosc frames the native encoder writes may differ from
another encoder's bytes; they decode to the same arrays.

The codec is ``io/native/zarrcodec.cpp``, built with ``g++`` with the text
decoders; where it cannot be built a Blosc chunk raises (there is no
Python fallback).  ``zlib`` and ``gzip`` chunks go through Python's
``zlib``.
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

__all__ = ["ZarrArray", "ZarrWriter", "zarr_metadata", "store_format",
           "blosc_decode", "blosc_encode"]

N_THREADS = min(8, os.cpu_count() or 1)

BLOSC_COMPRESSORS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib",
                     4: "zstd"}
_STATUS = {-1: "truncated Blosc frame",
           -2: "unsupported Blosc frame version",
           -5: "Blosc frame of another size than the chunk",
           -6: "corrupt LZ4 stream in a Blosc frame",
           -7: "malformed Blosc frame"}
_METADATA = {"zarr": ".zarray", "zarr3": "zarr.json", "n5": "attributes.json"}

_pool = None
_pool_lock = threading.Lock()


def _io_pool():
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(N_THREADS,
                                       thread_name_prefix="zarr-io")
        return _pool


def store_format(path):
    """``'zarr3'``, ``'zarr'`` or ``'n5'`` for the metadata file in the
    directory ``path`` (in that order of precedence), else None."""
    for fmt in ("zarr3", "zarr", "n5"):
        if os.path.exists(os.path.join(path, _METADATA[fmt])):
            return fmt
    return None


# ------------------------------------------------------------------ codec
def _codec():
    from sitator_tpu_torch.io import native
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(
            "Blosc-compressed zarr chunks need the native codec "
            "(sitator_tpu_torch/io/native/zarrcodec.cpp), which is built "
            "with g++ at first use; g++ is not usable here")
    return lib


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data for a in arrays])


def _frame_error(frame, status):
    if status == -3:
        code = (int(frame[2]) >> 5) & 7
        return ValueError(
            "Blosc compressor "
            f"{BLOSC_COMPRESSORS.get(code, f'code {code}')!r} is not "
            "supported (the codec decodes LZ4 frames)")
    if status == -4:
        return ValueError("Blosc bitshuffle is not supported (the codec "
                          "undoes byte shuffle)")
    return ValueError(_STATUS.get(status, f"Blosc status {status}"))


def blosc_decode(frames, outs):
    """Decode each Blosc frame (a uint8 array) into the matching writable
    C-contiguous array of ``outs``, whose size must be the frame's decoded
    size.  All frames in one native call on :data:`N_THREADS` threads;
    raises ``ValueError`` naming the first frame's fault."""
    if not frames:
        return
    lib = _codec()
    n = len(frames)
    src = [np.ascontiguousarray(f, dtype=np.uint8).reshape(-1)
           for f in frames]
    dst = [o.reshape(-1).view(np.uint8) for o in outs]
    status = np.zeros(n, np.int32)
    rc = lib.zc_blosc_decode(
        n, _ptrs(src), (ctypes.c_int64 * n)(*[s.size for s in src]),
        _ptrs(dst), (ctypes.c_int64 * n)(*[d.size for d in dst]),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), N_THREADS)
    if rc != 0:
        i = int(np.flatnonzero(status)[0])
        raise _frame_error(src[i], int(status[i]))


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


# ---------------------------------------------------------------- metadata
def _v3_fill(value, dtype):
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise ValueError(f"zarr v3 fill_value {value!r} is not "
                             "supported")
        value = special[value]
    return dtype.type(value)


def _dtype(name, where):
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"{where} data type {name!r} is not supported") \
            from None
    if dt.kind not in "fiub":
        raise ValueError(f"{where} data type {name!r} is not supported")
    return dt


class ZarrArray:
    """A zarr v2, zarr v3 or n5 array in the directory ``path``.

    Attributes: ``format`` (``'zarr'``, ``'zarr3'``, ``'n5'``), ``shape``,
    ``chunks``, ``dtype`` (as stored, with its byte order), ``fill_value``,
    ``metadata`` (the parsed metadata file).
    """

    def __init__(self, path, fmt=None):
        self.path = os.fspath(path)
        self.format = fmt or store_format(self.path)
        if self.format is None:
            raise ValueError(f"{self.path} is not a zarr/zarr3/n5 array "
                             "store")
        with open(os.path.join(self.path, _METADATA[self.format])) as f:
            self.metadata = m = json.load(f)
        self._compressor = None       # (name, config) of bytes -> bytes
        self._fortran = False
        self._cache_lock = threading.Lock()
        self._cache = None            # (chunk index, decoded chunk)
        getattr(self, f"_parse_{self.format}")(m)
        self.shape = tuple(int(s) for s in self.shape)
        self.chunks = tuple(int(c) for c in self.chunks)
        if len(self.chunks) != len(self.shape) or min(self.chunks,
                                                      default=1) < 1:
            raise ValueError(f"{self.path}: chunk shape {self.chunks} does "
                             f"not fit the array shape {self.shape}")
        self.ndim = len(self.shape)
        self.grid = tuple(math.ceil(s / c) if s else 0
                          for s, c in zip(self.shape, self.chunks))

    # -- metadata of each format
    def _parse_zarr(self, m):
        if m.get("zarr_format") != 2:
            raise ValueError(f"{self.path}: .zarray zarr_format "
                             f"{m.get('zarr_format')!r}")
        self.shape, self.chunks = m["shape"], m["chunks"]
        self.dtype = _dtype(m["dtype"], "zarr v2")
        if m.get("filters"):
            raise ValueError("zarr v2 filters are not supported: "
                             + ", ".join(repr(f.get("id")) for f in
                                         m["filters"]))
        comp = m.get("compressor")
        if comp is not None:
            self._compressor = self._bytes_codec(comp.get("id"), comp,
                                                 "zarr v2 compressor")
        order = m.get("order", "C")
        if order not in ("C", "F"):
            raise ValueError(f"zarr v2 order {order!r}")
        self._fortran = order == "F"
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
        self.shape = m["shape"]
        grid = m["chunk_grid"]
        if grid.get("name") != "regular":
            raise ValueError(f"zarr v3 chunk grid {grid.get('name')!r} is "
                             "not supported")
        self.chunks = grid["configuration"]["chunk_shape"]
        if m.get("storage_transformers"):
            raise ValueError("zarr v3 storage transformers are not "
                             "supported")
        self.dtype = _dtype(m["data_type"], "zarr v3")
        codecs = list(m["codecs"])
        first = codecs.pop(0) if codecs else {}
        if first.get("name") != "bytes":
            raise ValueError(f"zarr v3 codec {first.get('name')!r} is not "
                             "supported (the store reads bytes, then gzip "
                             "or blosc)")
        endian = (first.get("configuration") or {}).get("endian", "little")
        self.dtype = self.dtype.newbyteorder("<" if endian == "little"
                                             else ">")
        if len(codecs) > 1:
            raise ValueError("zarr v3 codecs after bytes: "
                             + ", ".join(repr(c.get("name")) for c in codecs)
                             + " (one of gzip, blosc is supported)")
        if codecs:
            c = codecs[0]
            self._compressor = self._bytes_codec(
                c.get("name"), c.get("configuration") or {}, "zarr v3 codec")
        self.fill_value = _v3_fill(m.get("fill_value", 0), self.dtype)
        enc = m.get("chunk_key_encoding", {"name": "default"})
        sep = (enc.get("configuration") or {}).get(
            "separator", "/" if enc.get("name") == "default" else ".")
        if enc.get("name") == "default":
            self._key = lambda idx: sep.join(["c", *map(str, idx)])
        elif enc.get("name") == "v2":
            self._key = lambda idx: sep.join(map(str, idx)) if idx else "0"
        else:
            raise ValueError(f"zarr v3 chunk key encoding "
                             f"{enc.get('name')!r} is not supported")

    def _parse_n5(self, m):
        self.shape, self.chunks = m["dimensions"], m["blockSize"]
        self.dtype = _dtype(m["dataType"], "n5").newbyteorder(">")
        comp = m.get("compression", {"type": "raw"})
        if comp.get("type") != "raw":
            self._compressor = self._bytes_codec(comp.get("type"), comp,
                                                 "n5 compression")
        self._fortran = True
        self.fill_value = self.dtype.type(0)
        self._key = lambda idx: "/".join(map(str, idx)) if idx else "0"

    @staticmethod
    def _bytes_codec(name, config, where):
        if name == "blosc":
            return "blosc", config
        if name in ("zlib", "gzip"):
            return "zlib", config
        raise ValueError(f"{where} {name!r} is not supported (raw, gzip, "
                         "zlib and blosc with LZ4 are)")

    # -- chunks
    def chunk_path(self, idx):
        return os.path.join(self.path, *self._key(idx).split("/"))

    def _chunk_extent(self, idx):
        return tuple(min(c, s - i * c)
                     for i, c, s in zip(idx, self.chunks, self.shape))

    def _read_file(self, path, into=None):
        """The file's bytes as a uint8 array (None if there is no such
        file); with ``into`` (a uint8 view of exactly the file's size) read
        straight into it and return it."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return None
        with f:
            size = os.fstat(f.fileno()).st_size
            buf = into if into is not None and into.size == size else \
                np.empty(size, np.uint8)
            got = f.readinto(memoryview(buf))
            if got != size:
                raise OSError(f"{path}: short read ({got} of {size} bytes)")
        return buf

    def _payload(self, raw, idx):
        """(payload bytes, the chunk's stored extent) of one chunk file: n5
        blocks carry their extent in a header."""
        if self.format != "n5":
            return raw, self.chunks
        head = raw[:4].view(">u2")
        mode, nd = int(head[0]), int(head[1])
        if mode not in (0, 1):
            raise ValueError(f"n5 block mode {mode} is not supported")
        ext = tuple(int(x) for x in raw[4:4 + 4 * nd].view(">u4"))
        off = 4 + 4 * nd + (4 if mode == 1 else 0)
        if len(ext) != self.ndim:
            raise ValueError(f"{self.chunk_path(idx)}: block of {len(ext)} "
                             f"dimensions in a {self.ndim}-d array")
        return raw[off:], ext

    def _arrange(self, flat, ext):
        """A chunk's elements (1-d, stored dtype) in the array's order."""
        if self._fortran:
            return flat.reshape(ext[::-1]).transpose()
        return flat.reshape(ext)

    def _plain(self, payload):
        if self._compressor is None or self._compressor[0] == "blosc":
            return payload
        return np.frombuffer(zlib.decompress(payload, 47), np.uint8)

    def read(self, lo, hi, dtype=np.float32):
        """Elements ``[lo, hi)`` of the leading axis, every other axis whole,
        as ``dtype``."""
        lo, hi = max(0, int(lo)), min(int(hi), self.shape[0])
        out = np.empty((max(0, hi - lo), *self.shape[1:]), dtype)
        if hi <= lo:
            return out
        c0 = self.chunks[0]
        rest = [range(g) for g in self.grid[1:]]
        idxs = [(i0, *r) for i0 in range(lo // c0, (hi - 1) // c0 + 1)
                for r in np.ndindex(*[len(x) for x in rest])]
        # the output's own layout: a chunk wholly inside the range, spanning
        # every other axis, goes straight into the output
        direct_ok = (not self._fortran and self.dtype == np.dtype(dtype)
                     and tuple(self.chunks[1:]) == tuple(self.shape[1:]))
        plain = self._compressor is None and self.format != "n5"

        def slot(idx):
            i0 = idx[0]
            if (direct_ok and i0 * c0 >= lo and (i0 + 1) * c0 <= hi):
                return out[i0 * c0 - lo:(i0 + 1) * c0 - lo]
            return None

        def load(idx):
            dst = slot(idx)
            into = dst.reshape(-1).view(np.uint8) if (
                dst is not None and plain) else None
            raw = self._read_file(self.chunk_path(idx), into)
            return raw, raw is not None and raw is into

        # a chunk read only in part is kept (the last one): strided reads of
        # single frames, as the streaming fit makes, decode each chunk once
        with self._cache_lock:
            cached = self._cache
        if cached is not None and cached[0] in idxs and slot(cached[0]) is None:
            self._place(out, lo, cached[0], cached[1])
            idxs = [i for i in idxs if i != cached[0]]
        if not idxs:
            return out
        loaded = list(_io_pool().map(load, idxs)) if len(idxs) > 1 else \
            [load(idxs[0])]
        frames, frame_outs, pending = [], [], []
        for idx, (raw, in_place) in zip(idxs, loaded):
            dst = slot(idx)
            if raw is None:
                self._place(out, lo, idx, None)
                continue
            if in_place:
                continue                      # read straight into the output
            payload, ext = self._payload(raw, idx)
            data = self._plain(payload)
            n_el = math.prod(ext)
            if self._compressor is not None and \
                    self._compressor[0] == "blosc":
                target = dst if (dst is not None and ext == self.chunks) \
                    else np.empty(n_el, self.dtype)
                frames.append(data)
                frame_outs.append(target)
                if target is not dst:
                    pending.append((idx, target, ext))
                continue
            if data.size != n_el * self.dtype.itemsize:
                raise ValueError(f"{self.chunk_path(idx)}: {data.size} bytes "
                                 f"for a chunk of {ext} {self.dtype}")
            pending.append((idx, data.view(self.dtype), ext))
        blosc_decode(frames, frame_outs)
        for idx, flat, ext in pending:
            chunk = self._arrange(flat, ext)
            self._place(out, lo, idx, chunk)
            with self._cache_lock:
                self._cache = idx, chunk
        return out

    def _place(self, out, lo, idx, chunk):
        """Copy the part of ``chunk`` (None: the fill value) inside the
        array and the range into ``out``."""
        start = [i * c for i, c in zip(idx, self.chunks)]
        ext = self._chunk_extent(idx)
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
