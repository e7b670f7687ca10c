"""The zarr v2 / zarr v3 / n5 layouts ``tensorstore`` writes, for the
port's reader (``sitator_tpu_torch/io/zarr_store.py``) to be held to.

``LAYOUTS`` maps a name to ``(driver, metadata, written)``: the
``tensorstore`` metadata of a ``(16, A, 3)`` store and the frames written
into it (a slice; the rest stays the fill value).  Frames come from
:func:`frames`: atoms on a lattice, a quarter of them displaced in each
frame by multiples of 1/64, so every chunk compresses (no Blosc frame is
stored as a memcpy frame, whatever the shuffle).

Run ``python -m tests._torch_zarr_layouts`` (with ``tensorstore``) to
write every layout, with its expected frames as ``<name>.npy``, into
``tests/data/torch_zarr_layouts/``: the fixtures ``chip_smoke.py`` reads
on a machine without ``tensorstore``.
"""
import os
import shutil
import struct
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(__file__), "data",
                        "torch_zarr_layouts")
N_FRAMES = 16
METADATA_FILES = (".zarray", "zarr.json", "attributes.json")


def frames(n_atoms=64, dtype=np.float32, seed=0):
    """(16, n_atoms, 3) frames that compress under any shuffle."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, (n_atoms, 3)) * 0.25
    out = np.repeat(base[None], N_FRAMES, 0)
    moved = rng.random((N_FRAMES, n_atoms)) < 0.25
    out[moved] += rng.integers(-8, 9, (int(moved.sum()), 3)) / 64
    return out.astype(dtype)


def _bytes(endian="little"):
    return {"name": "bytes", "configuration": {"endian": endian}}


def _v3(codecs, chunks=(4, 64, 3), data_type="float32", fill=0.0):
    return {"shape": [N_FRAMES, 64, 3], "data_type": data_type,
            "chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": list(chunks)}},
            "codecs": codecs, "fill_value": fill}


def _shard(inner_codecs, chunks=(4, 64, 3), index=("crc32c",),
           location="end"):
    return {"name": "sharding_indexed", "configuration": {
        "chunk_shape": list(chunks), "codecs": inner_codecs,
        "index_codecs": [_bytes()] + [{"name": n} for n in index],
        "index_location": location}}


def _zstd(level=3, checksum=False):
    return {"name": "zstd", "configuration": {"level": level,
                                              "checksum": checksum}}


def _v2(compressor, n_atoms=64, chunks=(4, 64, 3), order="C"):
    return {"shape": [N_FRAMES, n_atoms, 3], "chunks": list(chunks),
            "dtype": "<f4", "order": order, "compressor": compressor}


def _n5(compression):
    return {"dimensions": [N_FRAMES, 64, 3], "blockSize": [4, 64, 3],
            "dataType": "float32", "compression": compression}


ALL = slice(0, N_FRAMES)
LAYOUTS = {
    "v2_zstd": ("zarr", _v2({"id": "zstd", "level": 3}), ALL),
    "v2_bz2": ("zarr", _v2({"id": "bz2", "level": 9}), ALL),
    "v2_blosc_lz4_auto_f": ("zarr", _v2(
        {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": -1},
        chunks=(4, 32, 3), order="F"), ALL),
    # 63 atoms: 756 elements a chunk, not a multiple of 8, so a
    # bitshuffled block is stored as is
    "v2_blosc_zstd_bitshuffle_odd": ("zarr", _v2(
        {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2},
        n_atoms=63, chunks=(4, 63, 3)), ALL),
    **{f"v2_blosc_{cname}_{shuffle}": ("zarr", _v2(
        {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle}),
        ALL)
       for cname in ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")
       for shuffle in (0, 1, 2)},
    "v3_zstd": ("zarr3", _v3([_bytes(), _zstd()]), ALL),
    "v3_zstd_checksum_f8": ("zarr3", _v3([_bytes("big"), _zstd(
        checksum=True)], data_type="float64"), ALL),
    "v3_crc32c": ("zarr3", _v3([_bytes(), {"name": "crc32c"}]), ALL),
    "v3_transpose": ("zarr3", _v3([{"name": "transpose", "configuration":
                                    {"order": [2, 0, 1]}}, _bytes()],
                                  chunks=(4, 32, 3)), ALL),
    "v3_transpose_zstd_crc32c": ("zarr3", _v3(
        [{"name": "transpose", "configuration": {"order": [1, 2, 0]}},
         _bytes("big"), _zstd(), {"name": "crc32c"}]), ALL),
    **{f"v3_blosc_{shuffle}": ("zarr3", _v3([_bytes(), {
        "name": "blosc", "configuration": {
            "cname": cname, "clevel": 5, "shuffle": shuffle, "typesize": 4,
            "blocksize": 0}}]), ALL)
       for shuffle, cname in (("noshuffle", "blosclz"), ("shuffle", "lz4hc"),
                              ("bitshuffle", "zstd"))},
    "v3_sharded_zstd": ("zarr3", _v3([_shard([_bytes(), _zstd()])],
                                     chunks=(8, 64, 3)), ALL),
    "v3_sharded_gzip": ("zarr3", _v3([_shard([_bytes(), {
        "name": "gzip", "configuration": {"level": 5}}])],
        chunks=(8, 64, 3)), ALL),
    "v3_sharded_index_start": ("zarr3", _v3(
        [_shard([_bytes(), _zstd()], location="start")],
        chunks=(8, 64, 3)), ALL),
    "v3_sharded_nested": ("zarr3", _v3([_shard(
        [_shard([_bytes(), _zstd()], chunks=(2, 64, 3))], index=())],
        chunks=(8, 64, 3)), ALL),
    # frames [0, 4) only: the second inner chunk of the first shard is
    # absent from its index, the second shard file does not exist
    "v3_sharded_absent": ("zarr3", _v3([_shard([_bytes(), _zstd()])],
                                       chunks=(8, 64, 3), fill=7.5),
                          slice(0, 4)),
    "n5_bzip2": ("n5", _n5({"type": "bzip2", "blockSize": 9}), ALL),
    "n5_xz": ("n5", _n5({"type": "xz", "preset": 6}), ALL),
    "n5_zstd": ("n5", _n5({"type": "zstd", "level": 3}), ALL),
    "n5_blosc_zstd_bitshuffle": ("n5", _n5(
        {"type": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2}), ALL),
}


def layout_frames(name):
    """The frames a layout's store holds, as written, and as read back
    (the fill value where nothing was written)."""
    driver, meta, written = LAYOUTS[name]
    shape = meta.get("shape") or meta["dimensions"]
    dtype = np.dtype(meta.get("data_type") or meta.get("dtype")
                     or meta["dataType"])
    a = frames(shape[1], dtype)
    want = np.full_like(a, meta.get("fill_value") or 0)
    want[written] = a[written]
    return a[written], want


def write(path, name):
    """Write layout ``name`` at ``path`` with tensorstore; the frames it
    holds."""
    import tensorstore as ts
    driver, meta, written = LAYOUTS[name]
    data, want = layout_frames(name)
    arr = ts.open({"driver": driver,
                   "kvstore": {"driver": "file", "path": str(path)},
                   "metadata": meta},
                  create=True, delete_existing=True).result()
    arr[written].write(data).result()
    return want


def blosc_flags(path):
    """The header flags of every Blosc frame in a store directory (n5
    blocks: after their header)."""
    flags = set()
    for root, _, files in os.walk(path):
        for f in files:
            if f in METADATA_FILES or f.endswith((".npz", ".npy")):
                continue
            with open(os.path.join(root, f), "rb") as fh:
                head = fh.read(64)
            if os.path.exists(os.path.join(path, "attributes.json")):
                nd = struct.unpack(">H", head[2:4])[0]
                head = head[4 + 4 * nd:]
            flags.add(head[2])
    return flags


def main(out=FIXTURES):
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    for name in LAYOUTS:
        want = write(os.path.join(out, name), name)
        np.save(os.path.join(out, name + ".npy"), want)
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))
