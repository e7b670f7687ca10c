"""Chunked zarr trajectory stores (counterpart of
``sitator_tpu.io.tensorstore_io``; host NumPy).

At the 1M-frame x 10k-atom scale (about 120 GB in float32) the streaming
engine needs a chunked random-access store.  This module keeps the
reference's names and contract: frame-chunked zarr arrays behind the same
:class:`TrajectoryReader` protocol the rest of the IO layer speaks
(``len()``, ``r[lo:hi]``), so ``ChunkedFeeder`` /
``StreamingLandmarkAnalysis`` run off them unchanged.

The chunk layout is ``(chunk_frames, A, 3)`` — whole frames per chunk, so a
streaming block read is a contiguous chunk range with no re-assembly;
writes are issued asynchronously with a bounded in-flight window so
conversion overlaps IO with parsing.  A ``structure.npz`` sidecar inside
the store directory carries the
:class:`~sitator_tpu_torch.core.structure.Structure` (cell/species/
positions), restoring the full reader contract on open.

Local stores (a directory, or a tensorstore spec dict whose kvstore is
``file``) are read and written by :mod:`sitator_tpu_torch.io.zarr_store`
(zarr v2 / v3 / n5 metadata, the native Blosc/LZ4 codec): the metadata is
what ``tensorstore`` writes, and either package reads the other's stores.
``tensorstore`` itself is imported only to open a spec dict on another
kvstore (``gcs``, ``s3``, ``memory``), where it is installed.
"""
from __future__ import annotations

import os

import numpy as np

from sitator_tpu_torch.io.formats import TrajectoryReader, open_trajectory
from sitator_tpu_torch.io.zarr_store import ZarrArray, ZarrWriter, \
    store_format

__all__ = ["TensorstoreTrajectory", "convert_to_zarr"]

_SIDECAR = "structure.npz"
_DRIVERS = ("zarr", "zarr3", "n5")


def _ts():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "tensorstore is required to open a zarr store on a kvstore "
            "other than 'file' (pip install tensorstore); local stores "
            "need no library") from e
    return tensorstore


def _file_spec_path(spec):
    """(driver, directory) of a spec dict on a ``file`` kvstore, else
    None."""
    kv = spec.get("kvstore")
    if isinstance(kv, str):
        if not kv.startswith("file://"):
            return None
        base = kv[len("file://"):]
    elif isinstance(kv, dict) and kv.get("driver") == "file":
        base = kv.get("path", "")
    else:
        return None
    extra = sorted(set(spec) - {"driver", "kvstore", "path"})
    if extra:
        raise ValueError(f"spec keys {extra} are not supported for a local "
                         "store (driver, kvstore and path are)")
    if spec.get("driver") not in _DRIVERS:
        raise ValueError(f"spec driver {spec.get('driver')!r} is not one of "
                         f"{_DRIVERS}")
    return spec["driver"], os.path.join(base, spec.get("path", ""))


def is_zarr_store(path):
    """True if ``path`` is a directory holding a zarr/zarr3/n5 array."""
    return os.path.isdir(str(path)) and store_format(str(path)) is not None


def _load_sidecar(path):
    f = os.path.join(path, _SIDECAR)
    if not os.path.exists(f):
        return None
    from sitator_tpu_torch.core.structure import Structure
    with np.load(f) as d:
        return Structure(d["positions"], d["species"], d["cell"])


def _write_sidecar(path, structure):
    if structure is None:
        return
    np.savez(os.path.join(path, _SIDECAR),
             positions=np.asarray(structure.positions),
             species=np.asarray(structure.species),
             cell=np.asarray(structure.cell))


class TensorstoreTrajectory(TrajectoryReader):
    """Read a ``(F, A, 3)`` zarr/zarr3/n5 trajectory store.

    ``path`` is the store's directory, or a tensorstore spec dict: on a
    ``file`` kvstore the store is read here; any other kvstore (``gcs``,
    ``s3``, ``memory``) is opened through ``tensorstore``.  Blocks read as
    float32 in numpy's indexing: an int key gives one ``(A, 3)`` frame, a
    slice ``(n, A, 3)``.
    """

    def __init__(self, path, structure=None):
        self._path = self._ts = self._a = None
        local = None
        if isinstance(path, dict):
            local = _file_spec_path(path)
            if local is None:
                self._ts = _ts().open(path, read=True,
                                      write=False).result()
                shape = tuple(self._ts.shape)
        else:
            p = str(path)
            driver = store_format(p)
            if driver is None:
                raise ValueError(f"{p} is not a zarr/zarr3/n5 array store")
            local = driver, p
        if local is not None:
            self._path = local[1]
            self._a = ZarrArray(local[1], local[0])
            shape = self._a.shape
        if len(shape) != 3 or shape[2] != 3:
            raise ValueError(
                f"trajectory store must be (F, A, 3); got {shape}")
        self._shape = shape
        if structure is None and self._path is not None:
            structure = _load_sidecar(self._path)
        self.structure = structure

    def __len__(self):
        return int(self._shape[0])

    def __getitem__(self, key):
        if self._ts is not None:
            return np.asarray(self._ts[key].read().result(),
                              dtype=np.float32)
        n = len(self)
        if isinstance(key, slice):
            lo, hi, step = key.indices(n)
            if step == 1:
                return self._a.read(lo, hi)
            idx = np.arange(lo, hi, step)
            if not idx.size:
                return self._a.read(0, 0)
            first, last = int(idx.min()), int(idx.max())
            return self._a.read(first, last + 1)[idx - first]
        i = int(key)
        if not -n <= i < n:
            raise IndexError(f"frame {i} out of range [0, {n})")
        i %= n
        return self._a.read(i, i + 1)[0]


def _make_store(out_path, n_frames, n_atoms, dtype, chunk_frames,
                zarr_format):
    if zarr_format not in (2, 3):  # catch '3', 1, and other typos loudly
        raise ValueError(
            f"zarr_format must be 2 or 3 (int); got {zarr_format!r}")
    chunk = int(max(1, min(chunk_frames, n_frames)))
    return ZarrWriter(out_path, (n_frames, n_atoms, 3), dtype, chunk,
                      zarr_format)


def _convert_text_two_pass(p, fmt, out_path, dtype, chunk_frames,
                           zarr_format, variable_cell, verbose,
                           max_inflight):
    """Two-pass O(1)-memory text→zarr conversion (counting pass, then a
    chunk-buffered streaming write pass) — ``convert_to_npy`` parity for
    sources with no native decoder (incl. NPT rescale routes)."""
    n_frames = 0
    structure = None
    for structure, _ in _text_frame_iter(p, fmt, variable_cell):
        n_frames += 1
    if n_frames == 0:
        raise ValueError(f"no frames found in {p}")
    n_atoms = structure.n_atoms
    arr = _make_store(out_path, n_frames, n_atoms, dtype, chunk_frames,
                      zarr_format)
    chunk = arr.chunks[0]
    dt = np.dtype(dtype)
    buf = np.empty((chunk, n_atoms, 3), dt)
    fill = 0
    lo = 0
    inflight = []
    try:
        for _, pos in _text_frame_iter(p, fmt, variable_cell):
            buf[fill] = pos
            fill += 1
            if fill == chunk:
                inflight.append(arr.write(lo, buf.copy()))
                lo += fill
                fill = 0
                if len(inflight) >= max_inflight:
                    inflight.pop(0).result()
        if fill:
            inflight.append(arr.write(lo, buf[:fill].copy()))
        for fut in inflight:
            fut.result()
    finally:
        arr.close()
    _write_sidecar(str(out_path), structure)
    if verbose:
        print(f"wrote {n_frames} frames x {n_atoms} atoms to zarr store "
              f"{out_path} (two-pass, chunks of {chunk} frames)")
    return structure, str(out_path)


def _text_frame_iter(p, fmt, variable_cell):
    """Stream (structure, frame) pairs from a text trajectory — the shared
    O(1)-memory dispatch in ``formats.iter_text_frames``."""
    from sitator_tpu_torch.io.formats import iter_text_frames
    yield from iter_text_frames(p, fmt, variable_cell)


def convert_to_zarr(src, out_path, dtype=np.float32, chunk_frames=512,
                    zarr_format=2, variable_cell="error", verbose=False,
                    block_frames=1024, max_inflight=4):
    """Convert any trajectory source into a frame-chunked zarr store.

    ``src``: a :class:`TrajectoryReader` or a path accepted by
    :func:`~sitator_tpu_torch.io.formats.open_trajectory`.  Text formats go
    through the native indexed decoders when available (O(block) memory);
    otherwise — including every ``variable_cell='rescale'`` NPT source —
    they stream through the same two-pass O(1)-memory parse as
    :func:`~sitator_tpu_torch.io.formats.convert_to_npy`, so multi-GB text
    files convert without materializing the array.

    Writes are asynchronous with at most ``max_inflight`` blocks in
    flight, so parsing/reading overlaps store IO.  Returns
    ``(Structure or None, out_path)``.
    """
    if zarr_format not in (2, 3):  # fail in ms, not after a counting pass
        raise ValueError(
            f"zarr_format must be 2 or 3 (int); got {zarr_format!r}")
    reader = None
    if isinstance(src, TrajectoryReader):
        reader = src
    else:
        from sitator_tpu_torch.io.formats import (_try_native_reader,
                                                  sniff_format)
        p = str(src)
        fmt = sniff_format(p)
        if fmt in ("xyz", "lammps", "xdatcar"):
            if variable_cell == "error":
                reader = _try_native_reader(p, fmt)
            if reader is None:
                return _convert_text_two_pass(
                    p, fmt, out_path, dtype, chunk_frames, zarr_format,
                    variable_cell, verbose, max_inflight)
        else:
            reader = open_trajectory(p, variable_cell=variable_cell)
    n_frames = len(reader)
    n_atoms = reader.n_atoms
    structure = getattr(reader, "structure", None)
    out_path = str(out_path)

    arr = _make_store(out_path, n_frames, n_atoms, dtype, chunk_frames,
                      zarr_format)
    chunk = arr.chunks[0]

    # chunk-aligned write blocks; bounded async window overlaps read + write
    B = max(chunk, (int(block_frames) // chunk) * chunk)
    dt = np.dtype(dtype)
    inflight = []
    try:
        for lo in range(0, n_frames, B):
            hi = min(lo + B, n_frames)
            inflight.append(arr.write(lo, reader[lo:hi].astype(dt,
                                                               copy=False)))
            if len(inflight) >= max_inflight:
                inflight.pop(0).result()
        for fut in inflight:
            fut.result()
    finally:
        arr.close()

    _write_sidecar(out_path, structure)
    if verbose:
        print(f"wrote {n_frames} frames x {n_atoms} atoms to zarr store "
              f"{out_path} (chunks of {chunk} frames)")
    return structure, out_path
