"""ctypes bindings + on-demand build of the native text decoders
(counterpart of ``sitator_tpu.io.native``), of the zarr stores' codec
(Blosc, zstd, crc32c) and of the HDF5 chunks' codec (shuffle, LZF,
Fletcher-32, scale-offset).

``fastxyz.cpp``, ``fastlmp.cpp``, ``fastxd.cpp``, ``zarrcodec.cpp`` and
``h5codec.cpp`` are compiled with ``g++`` at first use into
``build/sitator_tpu_torch-fastio-<hash>/`` beside the package (the
directory the CUDA kernels build into), keyed by a hash of the sources and
flags, so a checkout builds from its own sources and never loads another
package's artefact.  Without ``g++`` the readers fall back to the Python
parsers, as the reference does; a zarr store whose codecs need the native
codec then raises at open (``io/zarr_store.py``: it has no Python
fallback), and so does an HDF5 dataset whose filters need it
(``io/h5_store.py``).

The per-file index caches (``.fxyzidx.npz``, ``.flmpidx.npz``,
``.fxdidx.npz`` beside the trajectory) have the reference's names and
layout, so either package reads a cache the other wrote.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "fastxyz.cpp", _HERE / "fastlmp.cpp", _HERE / "fastxd.cpp",
         _HERE / "zarrcodec.cpp", _HERE / "h5codec.cpp"]
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
# portable flag set (no -march=native: the library may be shared across
# heterogeneous hosts); the parsers are scalar, -O3 is all they need
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# after the sources: dlopen for the zarr codec's libz.so.1 / libzstd.so.1
# (in libc itself from glibc 2.34 on)
_LIBS = ["-ldl"]
_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library for these exact sources and flags lives.  No
    ".so" suffix: module walkers must not mistake it for an importable
    extension module; dlopen does not care."""
    h = hashlib.sha256()
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return (BUILD_ROOT / f"sitator_tpu_torch-fastio-{h.hexdigest()[:16]}"
            / "libfastio.bin")


def _build(lib):
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"libfastio.{os.getpid()}.bin")
    subprocess.run(["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp),
                    *_LIBS], check=True, capture_output=True)
    os.replace(tmp, lib)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError) as e:
            logger.warning("fast-IO native build unavailable (%s); "
                           "falling back to the Python parsers", e)
            return None
        lib.fxyz_index.restype = ctypes.c_int64
        lib.fxyz_index.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.fxyz_read_block.restype = ctypes.c_int
        lib.fxyz_read_block.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.flmp_index.restype = ctypes.c_int64
        lib.flmp_index.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.flmp_read_block.restype = ctypes.c_int
        lib.flmp_read_block.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.fxd_index.restype = ctypes.c_int64
        lib.fxd_index.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.fxd_read_block.restype = ctypes.c_int
        lib.fxd_read_block.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.zc_blosc_decode.restype = ctypes.c_int
        lib.zc_blosc_decode.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int]
        lib.zc_zstd_decode.restype = ctypes.c_int
        lib.zc_zstd_decode.argtypes = lib.zc_blosc_decode.argtypes
        lib.zc_zstd_content_size.restype = ctypes.c_int64
        lib.zc_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.zc_crc32c.restype = ctypes.c_uint32
        lib.zc_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.zc_libraries.restype = ctypes.c_int
        lib.zc_libraries.argtypes = []
        lib.zc_blosc_encode.restype = ctypes.c_int
        lib.zc_blosc_encode.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        lib.h5c_unshuffle.restype = None
        lib.h5c_unshuffle.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.h5c_lzf_decode.restype = ctypes.c_int64
        lib.h5c_lzf_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64]
        lib.h5c_fletcher32.restype = ctypes.c_uint32
        lib.h5c_fletcher32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.h5c_scaleoffset_decode.restype = ctypes.c_int
        lib.h5c_scaleoffset_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


class _IndexedNativeTrajectory:
    """Shared machinery for natively-indexed text trajectories: the
    cap-retry index scan, the per-(size, mtime) index cache, and the
    ``TrajectoryReader`` protocol.  Subclasses set ``_index_name``,
    ``_cache_suffix`` and implement ``_read_range``/``_load_structure``."""

    _index_name = None
    _cache_suffix = None

    def _precheck(self):
        pass

    def __init__(self, path, n_threads=None, cache_index=True):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fast-IO library unavailable")
        self._lib = lib
        self.path = os.fspath(path)
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._file_size = os.path.getsize(self.path)
        # cheap format preconditions run BEFORE the (potentially multi-GB)
        # index scan, so unsupported files fall back without paying for it
        self._precheck()

        cached = self._load_index_cache() if cache_index else None
        if cached is not None:
            self._offsets, self._n_frames, self._n_atoms = cached
        else:
            # first pass with a generous guess; retry bigger if needed
            cap = max(1024, self._file_size // 64)
            while True:
                offsets = np.zeros(cap, dtype=np.int64)
                n, n_atoms = self._index_call(offsets, cap)
                if n < 0:
                    raise IOError(
                        f"{self._index_name} failed with code {n}")
                if n_atoms == -2:
                    raise ValueError(
                        "inconsistent atom counts across frames")
                if n <= cap:
                    break
                cap = n
            self._offsets = np.ascontiguousarray(offsets[:n])
            self._n_frames = int(n)
            self._n_atoms = int(n_atoms)
            if cache_index:
                self._save_index_cache()

        self._check_fixed_cell()
        self.structure = self._load_structure()

    def _first_frame(self, it):
        """First frame from a Python parser, with an empty/unparseable file
        surfacing as ValueError rather than a leaked StopIteration (the
        native indexer can accept byte layouts the Python reader rejects)."""
        try:
            return next(it)
        except StopIteration:
            raise ValueError(
                f"no parseable frames in {self.path}") from None

    # the native decoders are fixed-cell by design; subclasses override
    # this with a cheap sampled check so NPT files raise (and
    # open_trajectory falls back to the Python readers' full-scan error)
    # instead of being silently read with frame 0's cell
    def _check_fixed_cell(self):
        pass

    def _sample_frames(self, k=8):
        n = self._n_frames
        if n <= 1:
            return []
        idx = {0, n - 1}
        idx.update(int(i) for i in
                   np.linspace(0, n - 1, num=min(k, n), dtype=np.int64))
        return sorted(idx)

    def _index_call(self, offsets, cap):
        """One native index invocation: returns (n_frames, n_atoms)."""
        n_atoms = ctypes.c_int64(0)
        n = getattr(self._lib, self._index_name)(
            self.path.encode(),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
            ctypes.byref(n_atoms))
        return n, n_atoms.value

    # index cache: one scan per (file, size, mtime) — amortizes the index
    # pass for repeated streaming runs over large (multi-GB) trajectories
    def _cache_path(self):
        return self.path + self._cache_suffix

    def _load_index_cache(self):
        cp = self._cache_path()
        try:
            st = os.stat(self.path)
            with np.load(cp) as d:
                if (int(d["size"]) == st.st_size
                        and int(d["mtime_ns"]) == st.st_mtime_ns):
                    return (np.ascontiguousarray(d["offsets"]),
                            int(d["n_frames"]), int(d["n_atoms"]))
        except Exception:
            # any unreadable/corrupt sidecar (truncated zip, bad pickle,
            # permissions) must degrade to a fresh index scan, never crash
            return None
        return None

    def _save_index_cache(self):
        try:
            st = os.stat(self.path)
            tmp = self._cache_path() + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, offsets=self._offsets,
                         n_frames=self._n_frames, n_atoms=self._n_atoms,
                         size=st.st_size, mtime_ns=st.st_mtime_ns)
            os.replace(tmp, self._cache_path())
        except OSError:
            pass  # read-only location; index stays in-memory only

    def __len__(self):
        return self._n_frames

    @property
    def n_atoms(self):
        return self._n_atoms

    def __getitem__(self, key):
        scalar = not isinstance(key, slice)
        if scalar:
            key = int(key)
            if key < 0:
                key += self._n_frames
            if not 0 <= key < self._n_frames:
                raise IndexError(
                    f"frame {key} out of range [0, {self._n_frames})")
            lo, hi = key, key + 1
        else:
            lo, hi, step = key.indices(self._n_frames)
            if step != 1:
                raise ValueError("only contiguous slices supported")
        n = hi - lo
        out = np.empty((n, self._n_atoms, 3), dtype=np.float32)
        if n > 0:
            rc = self._read_range(lo, n, out)
            if rc != 0:
                raise IOError(f"{type(self).__name__} read failed "
                              f"with code {rc}")
        # numpy indexing semantics, matching ArrayTrajectory: an int key
        # returns one (A, 3) frame, a slice returns (n, A, 3)
        return out[0] if scalar else out


class FastXYZTrajectory(_IndexedNativeTrajectory):
    """Random-access, multithreaded extxyz trajectory reader (native).

    Implements the ``TrajectoryReader`` protocol.  Index is built once
    (single scan); block reads decode frames across ``n_threads``.
    Fixed-cell by design: per-frame ``Lattice=`` consistency is verified
    on a frame SAMPLE (first/last + evenly spaced — catches real NPT
    runs, not a proof); mismatches raise so ``open_trajectory`` falls
    back to the Python reader's full-scan error.  Use
    ``variable_cell='rescale'`` for NPT extxyz files.
    """

    _index_name = "fxyz_index"
    _cache_suffix = ".fxyzidx.npz"

    def _precheck(self):
        """The native frame parser skips ONE leading token then reads 3
        floats — i.e. the standard species-first layout (pos at fields
        1..3).  Files whose Properties= declares another column order
        fall back to the Python parser, which honors the declaration."""
        from sitator_tpu_torch.io.formats import _parse_properties
        with open(self.path) as f:
            f.readline()
            sp_f, pos_f = _parse_properties(f.readline())
        if pos_f != 1:
            raise ValueError(
                "native extxyz decoder needs the species-first column "
                f"layout (pos at field 1, got field {pos_f}); using the "
                "Python parser")

    def _check_fixed_cell(self):
        from sitator_tpu_torch.io.formats import (_parse_comment,
                                                  _parse_properties)
        ref = None
        with open(self.path) as f:
            for i in self._sample_frames():
                f.seek(int(self._offsets[i]))
                f.readline()                       # atom-count line
                comment = f.readline()
                cell = _parse_comment(comment)
                # concatenated files can switch column layouts mid-stream;
                # the native parser is species-first-only (same sampled
                # check as the cell)
                _, pos_f = _parse_properties(comment)
                if pos_f != 1:
                    raise ValueError(
                        "extxyz frame with a non-species-first Properties "
                        "layout: the native decoder is fixed-layout; "
                        "falling back")
                if i == 0:
                    ref = cell
                elif (cell is None) != (ref is None) or (
                        cell is not None
                        and not np.allclose(cell, ref, atol=1e-8)):
                    raise ValueError(
                        "variable-cell extxyz (per-frame Lattice=): the "
                        "native decoder is fixed-cell; falling back")

    def _load_structure(self):
        from sitator_tpu_torch.io.formats import iread_xyz
        return self._first_frame(iread_xyz(self.path))

    def _read_range(self, lo, n, out):
        return self._lib.fxyz_read_block(
            self.path.encode(),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_frames, self._file_size, lo, n, self._n_atoms,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)


class FastLammpsTrajectory(_IndexedNativeTrajectory):
    """Random-access, multithreaded LAMMPS text-dump reader (native).

    Cartesian coordinate columns only (``x y z`` / ``xu yu zu``); raises
    ValueError for scaled-coordinate dumps so callers fall back to the
    Python parser (which converts through the box).
    """

    _index_name = "flmp_index"
    _cache_suffix = ".flmpidx.npz"

    def _precheck(self):
        """Column layout + id contiguity from frame 0 — cheap text reads
        that reject unsupported dumps (scaled coords, group dumps with
        non-contiguous global ids) BEFORE the native index scan, so
        ``open_trajectory`` falls back to the Python parser for them."""
        cols = None
        n_atoms = None
        try:
            with open(self.path) as f:
                for line in f:
                    if line.startswith("ITEM: NUMBER OF ATOMS"):
                        n_atoms = int(next(f))
                        if n_atoms < 0:
                            raise ValueError(
                                f"negative atom count {n_atoms}")
                    elif line.startswith("ITEM: ATOMS"):
                        cols = line.split()[2:]
                        if n_atoms is None:
                            raise ValueError("malformed LAMMPS dump header")
                        ids = None
                        if "id" in cols:
                            idc = cols.index("id")
                            ids = np.empty(n_atoms, np.int64)
                            for i in range(n_atoms):
                                ids[i] = int(next(f).split()[idc])
                        break
                else:
                    raise ValueError(
                        f"no ITEM: ATOMS header in {self.path}")
        except StopIteration:
            raise ValueError(
                f"truncated LAMMPS dump header in {self.path}") from None
        for cset in (("x", "y", "z"), ("xu", "yu", "zu")):
            if all(c in cols for c in cset):
                self._col_xyz = (ctypes.c_int * 3)(
                    *[cols.index(c) for c in cset])
                break
        else:
            raise ValueError(
                "native LAMMPS decoder handles cartesian columns only "
                f"(got {cols}); use the Python reader for scaled dumps")
        if "id" in cols:
            if not np.array_equal(np.sort(ids),
                                  np.arange(1, n_atoms + 1)):
                raise ValueError(
                    "native LAMMPS decoder needs atom ids 1..n_atoms "
                    "(group dumps keep global ids); use the Python reader")
            self._col_id = cols.index("id")
        else:
            self._col_id = -1

    def _check_fixed_cell(self):
        ref = None
        with open(self.path) as f:
            for i in self._sample_frames():
                f.seek(int(self._offsets[i]))
                rows = None
                for _ in range(12):
                    line = f.readline()
                    if line.startswith("ITEM: BOX BOUNDS"):
                        rows = np.array(
                            [[float(x) for x in f.readline().split()]
                             for _ in range(3)])
                        break
                if rows is None:
                    raise ValueError("malformed LAMMPS frame header")
                if i == 0:
                    ref = rows
                elif rows.shape != ref.shape or not np.allclose(
                        rows, ref, atol=1e-8):
                    raise ValueError(
                        "variable-cell LAMMPS dump (per-frame box "
                        "bounds): the native decoder is fixed-cell; "
                        "falling back")

    def _load_structure(self):
        from sitator_tpu_torch.io.formats import iread_lammps_dump
        structure, _ = self._first_frame(iread_lammps_dump(self.path))
        return structure

    def _read_range(self, lo, n, out):
        return self._lib.flmp_read_block(
            self.path.encode(),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_frames, self._file_size, lo, n, self._n_atoms,
            self._col_id, self._col_xyz,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)


class FastXDATCARTrajectory(_IndexedNativeTrajectory):
    """Random-access, multithreaded VASP XDATCAR reader (native).

    Fixed-cell variant only (a repeated header mid-file fails the index,
    and ``open_trajectory`` falls back to the Python reader's clear
    variable-cell error).  The native pass decodes fractional coordinates;
    the cell product happens vectorized in numpy per block.
    """

    _index_name = "fxd_index"
    _cache_suffix = ".fxdidx.npz"

    def _precheck(self):
        from sitator_tpu_torch.io.formats import parse_xdatcar_header
        with open(self.path) as f:
            cell, _, counts, self._header_end = parse_xdatcar_header(f)
        self._cell32 = cell.astype(np.float32)
        self._n_atoms_expected = sum(counts)

    def _index_call(self, offsets, cap):
        n = self._lib.fxd_index(
            self.path.encode(), self._header_end, self._n_atoms_expected,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        return n, self._n_atoms_expected

    def _load_structure(self):
        from sitator_tpu_torch.io.formats import iread_xdatcar
        structure, _ = self._first_frame(iread_xdatcar(self.path))
        return structure

    def _read_range(self, lo, n, out):
        rc = self._lib.fxd_read_block(
            self.path.encode(),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_frames, self._file_size, lo, n, self._n_atoms,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)
        if rc == 0:
            out[:] = out @ self._cell32   # fractional -> cartesian
        return rc
