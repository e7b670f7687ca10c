"""Tensorstore-backed chunked trajectory store (counterpart of
``sitator_tpu.io.tensorstore_io``; host NumPy).

At the 1M-frame x 10k-atom scale (about 120 GB in float32) the streaming
engine needs a chunked random-access store whose reads can ride object
storage as well as local disk.  ``tensorstore`` is that store: frame-chunked
zarr arrays behind the same :class:`TrajectoryReader` protocol the rest of
the IO layer speaks (``len()``, ``r[lo:hi]``), so ``ChunkedFeeder`` /
``StreamingLandmarkAnalysis`` run off it unchanged.

The chunk layout is ``(chunk_frames, A, 3)`` — whole frames per chunk, so a
streaming block read is a contiguous chunk range with no re-assembly;
writes are issued asynchronously with a bounded in-flight window so
conversion overlaps IO with parsing.  A ``structure.npz`` sidecar inside
the store directory carries the
:class:`~sitator_tpu_torch.core.structure.Structure` (cell/species/
positions), restoring the full reader contract on open.  ``tensorstore`` is
imported only when a store is opened or written.
"""
from __future__ import annotations

import os

import numpy as np

from sitator_tpu_torch.io.formats import TrajectoryReader, open_trajectory

__all__ = ["TensorstoreTrajectory", "convert_to_zarr"]

_SIDECAR = "structure.npz"


def _ts():
    try:
        import tensorstore
    except ImportError as e:  # pragma: no cover - installed in this env
        raise ImportError(
            "tensorstore is required for zarr trajectory stores "
            "(pip install tensorstore)") from e
    return tensorstore


def _zarr_driver(path):
    """Which tensorstore driver serves this store directory."""
    if os.path.exists(os.path.join(path, "zarr.json")):
        return "zarr3"
    if os.path.exists(os.path.join(path, ".zarray")):
        return "zarr"
    if os.path.exists(os.path.join(path, "attributes.json")):
        return "n5"
    return None


def is_zarr_store(path):
    """True if ``path`` is a directory holding a zarr/zarr3/n5 array."""
    return os.path.isdir(str(path)) and _zarr_driver(str(path)) is not None


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

    ``path`` may also be a full tensorstore spec dict (any kvstore —
    ``file``, ``gcs``, ``s3``, ``memory`` — works; the reader only needs
    random block reads).
    """

    def __init__(self, path, structure=None):
        ts = _ts()
        if isinstance(path, dict):
            spec = path
            self._path = None
        else:
            p = str(path)
            driver = _zarr_driver(p)
            if driver is None:
                raise ValueError(f"{p} is not a zarr/zarr3/n5 array store")
            spec = {"driver": driver,
                    "kvstore": {"driver": "file", "path": p}}
            self._path = p
        self._a = ts.open(spec, read=True, write=False).result()
        if self._a.ndim != 3 or self._a.shape[2] != 3:
            raise ValueError(
                f"trajectory store must be (F, A, 3); got {self._a.shape}")
        if structure is None and self._path is not None:
            structure = _load_sidecar(self._path)
        self.structure = structure

    def __len__(self):
        return int(self._a.shape[0])

    def __getitem__(self, key):
        return np.asarray(self._a[key].read().result(), dtype=np.float32)


def _make_store(ts, out_path, n_frames, n_atoms, dtype, chunk_frames,
                zarr_format):
    if zarr_format not in (2, 3):  # catch '3', 1, and other typos loudly
        raise ValueError(
            f"zarr_format must be 2 or 3 (int); got {zarr_format!r}")
    dt = np.dtype(dtype)
    chunk = [int(max(1, min(chunk_frames, n_frames))), n_atoms, 3]
    if zarr_format == 3:
        spec = {"driver": "zarr3",
                "kvstore": {"driver": "file", "path": str(out_path)},
                "metadata": {
                    "shape": [n_frames, n_atoms, 3],
                    "data_type": dt.name,
                    "chunk_grid": {"name": "regular",
                                   "configuration": {"chunk_shape": chunk}},
                }}
    else:
        spec = {"driver": "zarr",
                "kvstore": {"driver": "file", "path": str(out_path)},
                "metadata": {"shape": [n_frames, n_atoms, 3],
                             "chunks": chunk,
                             "dtype": dt.newbyteorder("<").str}}
    return ts.open(spec, create=True, delete_existing=True).result(), chunk


def _convert_text_two_pass(ts, p, fmt, out_path, dtype, chunk_frames,
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
    arr, chunk = _make_store(ts, out_path, n_frames, n_atoms, dtype,
                             chunk_frames, zarr_format)
    dt = np.dtype(dtype)
    buf = np.empty((chunk[0], n_atoms, 3), dt)
    fill = 0
    lo = 0
    inflight = []
    for _, pos in _text_frame_iter(p, fmt, variable_cell):
        buf[fill] = pos
        fill += 1
        if fill == chunk[0]:
            inflight.append(arr[lo:lo + fill].write(buf.copy()))
            lo += fill
            fill = 0
            if len(inflight) >= max_inflight:
                inflight.pop(0).result()
    if fill:
        inflight.append(arr[lo:lo + fill].write(buf[:fill].copy()))
    for fut in inflight:
        fut.result()
    _write_sidecar(str(out_path), structure)
    if verbose:
        print(f"wrote {n_frames} frames x {n_atoms} atoms to zarr store "
              f"{out_path} (two-pass, chunks of {chunk[0]} frames)")
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
    ts = _ts()
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
                    ts, p, fmt, out_path, dtype, chunk_frames, zarr_format,
                    variable_cell, verbose, max_inflight)
        else:
            reader = open_trajectory(p, variable_cell=variable_cell)
    n_frames = len(reader)
    n_atoms = reader.n_atoms
    structure = getattr(reader, "structure", None)
    out_path = str(out_path)

    arr, chunk = _make_store(ts, out_path, n_frames, n_atoms, dtype,
                             chunk_frames, zarr_format)

    # chunk-aligned write blocks; bounded async window overlaps read + write
    B = max(chunk[0], (int(block_frames) // chunk[0]) * chunk[0])
    dt = np.dtype(dtype)
    inflight = []
    for lo in range(0, n_frames, B):
        hi = min(lo + B, n_frames)
        fut = arr[lo:hi].write(reader[lo:hi].astype(dt, copy=False))
        inflight.append(fut)
        if len(inflight) >= max_inflight:
            inflight.pop(0).result()
    for fut in inflight:
        fut.result()

    _write_sidecar(out_path, structure)
    if verbose:
        print(f"wrote {n_frames} frames x {n_atoms} atoms to zarr store "
              f"{out_path} (chunks of {chunk[0]} frames)")
    return structure, out_path
