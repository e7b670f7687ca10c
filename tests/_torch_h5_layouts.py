"""The HDF5 layouts ``h5py`` writes, for the port's reader
(``sitator_tpu_torch/io/h5_store.py``) to be held to.

``LAYOUTS`` maps a name to the options of one file: the ``libver`` bounds
(``earliest``: superblock v0, v1 object headers, old-style groups, layout
v3 with a v1 B-tree; ``v108``: superblock v2, v2 object headers, new-style
groups; ``latest``: superblock v3, layout v4 with its five chunk indices),
the dataset's storage (contiguous, compact or chunked, its filters, szip
and n-bit included, its fill value, which frames are written), its type
(custom integer and float layouts made with h5py's low-level API) and the
file's structure around it (an H5MD path, a soft link, a dense group,
creation order, a user block, many attributes, SWMR, a shared-message
table made through h5py's own libhdf5).  Frames come from :func:`frames`:
atoms on a lattice, a quarter of them displaced in each frame by
multiples of 1/64, so every chunk compresses; ``incompressible`` layouts
use random bytes instead, which LZF stores raw.

``MULTI`` maps a name to a writer of a layout of several files, kept in a
directory of its own: virtual datasets over segment files (``.``
sources, strided and interleaved mappings, unmapped frames, missing
sources, a union of blocks), external links (a chain through a soft link
too) and external storage, which HDF5 resolves against the working
directory (``CWD``).  ``REFUSED`` names the layouts the port refuses by
name and the reference cannot read either (plugin filters on filtered
chunks, a compound type); they have no ``.npy``.

Run ``python -m tests._torch_h5_layouts`` (with ``h5py``) to write every
layout (``<name>.h5``, or ``<name>/<name>.h5`` beside its other files),
with what the reference's ``H5Trajectory`` reads from it (cast to
float32) as ``<name>.npy``, into ``tests/data/torch_h5_layouts/``, and the
headers of :func:`bench_headers` into ``tests/data/torch_h5_bench/``: the
fixtures ``chip_smoke.py`` reads on a machine without ``h5py``.
"""
import math
import os
import shutil
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(__file__), "data",
                        "torch_h5_layouts")
N_FRAMES = 16
KEY = "positions"
H5MD_KEY = "particles/all/position/value"


def frames(n_frames=N_FRAMES, n_atoms=64, seed=0):
    """(n_frames, n_atoms, 3) float64 frames that compress."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, (n_atoms, 3)) * 0.25
    out = np.repeat(base[None], n_frames, 0)
    moved = rng.random((n_frames, n_atoms)) < 0.25
    out[moved] += rng.integers(-8, 9, (int(moved.sum()), 3)) / 64
    return out


def incompressible(n_frames=N_FRAMES, n_atoms=64, seed=0):
    """Random float32 frames: LZF cannot shrink them."""
    rng = np.random.default_rng(seed)
    return rng.random((n_frames, n_atoms, 3)).astype(np.float32) * 10


# chunked layouts with the same chunk shape unless they say otherwise
C = (4, 16, 3)
S = (N_FRAMES, 16, 3)              # the shape of the later, smaller layouts
LAYOUTS = {
    # storage without filters, under each format version
    **{f"{lv}_contiguous": dict(libver=lv)
       for lv in ("earliest", "v108", "latest")},
    **{f"{lv}_compact": dict(libver=lv, layout="compact")
       for lv in ("earliest", "latest")},
    "earliest_contiguous_unwritten": dict(written=slice(0, 0),
                                          fillvalue=-2.5),
    "earliest_chunked": dict(chunks=C),
    "earliest_chunked_maxshape": dict(chunks=C, maxshape=(None, 64, 3)),
    "v108_chunked_maxshape": dict(libver="v108", chunks=C,
                                  maxshape=(None, 64, 3)),
    "earliest_ragged_edges": dict(chunks=(5, 20, 2)),
    # 256 chunks: a v1 B-tree of two levels
    "earliest_btree1_deep": dict(chunks=(1, 4, 3)),
    "earliest_unallocated_fill": dict(chunks=C, fillvalue=7.5,
                                      written=slice(0, 5)),
    # the five chunk indices of layout v4
    "latest_single_chunk": dict(libver="latest", chunks=(16, 64, 3)),
    "latest_single_chunk_gzip": dict(libver="latest", chunks=(16, 64, 3),
                                     compression="gzip"),
    "latest_implicit": dict(libver="latest", chunks=C, alloc="early"),
    "latest_implicit_fill": dict(libver="latest", chunks=(5, 20, 2),
                                 alloc="early", fillvalue=3.0,
                                 written=slice(2, 7)),
    "latest_fixed_array": dict(libver="latest", chunks=C),
    "latest_fixed_array_gzip_ragged": dict(libver="latest",
                                           chunks=(5, 20, 2),
                                           compression="gzip"),
    # 3072 chunks: a paged fixed array, unfiltered and filtered
    "latest_fixed_array_paged": dict(libver="latest", chunks=(1, 1, 1)),
    "latest_fixed_array_paged_gzip": dict(libver="latest", chunks=(1, 2, 1),
                                          compression="gzip",
                                          compression_opts=1),
    "latest_fixed_array_unallocated_fill": dict(
        libver="latest", chunks=C, fillvalue=7.5, written=slice(6, 11)),
    # one unlimited axis: the extensible array, past its index block's
    # data blocks into super blocks (1030 chunks along the unlimited axis)
    "latest_extensible_array": dict(libver="latest", shape=(1030, 2, 3),
                                    chunks=(1, 2, 3),
                                    maxshape=(None, 2, 3)),
    "latest_extensible_array_gzip_fill": dict(
        libver="latest", shape=(1030, 2, 3), chunks=(1, 1, 3),
        maxshape=(None, 2, 3), compression="gzip", compression_opts=1,
        fillvalue=-1.0, written=slice(0, 700)),
    # two unlimited axes: the v2 B-tree (record types 10 and 11), one and
    # two levels deep
    "latest_btree2": dict(libver="latest", chunks=(1, 4, 3),
                          maxshape=(None, None, 3)),
    "latest_btree2_gzip_fill": dict(libver="latest", chunks=(1, 4, 3),
                                    maxshape=(None, None, 3),
                                    compression="gzip", fillvalue=9.0,
                                    written=slice(3, 13)),
    "latest_btree2_deep": dict(libver="latest", chunks=(1, 1, 1),
                               maxshape=(None, None, None)),
    # filters
    "earliest_gzip1": dict(chunks=C, compression="gzip",
                           compression_opts=1),
    "earliest_gzip9": dict(chunks=C, compression="gzip",
                           compression_opts=9),
    "earliest_shuffle_gzip": dict(chunks=C, compression="gzip",
                                  shuffle=True),
    "latest_shuffle_gzip_ragged": dict(libver="latest", chunks=(5, 20, 2),
                                       compression="gzip", shuffle=True),
    # layout v4's flag: partial edge chunks are stored unfiltered
    "latest_edges_not_filtered": dict(libver="latest", chunks=(5, 20, 2),
                                      compression="gzip", shuffle=True,
                                      edges_not_filtered=True),
    "earliest_lzf": dict(chunks=C, compression="lzf"),
    "latest_lzf_shuffle": dict(libver="latest", chunks=C,
                               compression="lzf", shuffle=True),
    "earliest_lzf_incompressible": dict(chunks=C, compression="lzf",
                                        data="incompressible"),
    "latest_lzf_incompressible": dict(libver="latest", chunks=C,
                                      compression="lzf",
                                      data="incompressible"),
    "earliest_fletcher32": dict(chunks=C, fletcher32=True),
    # chunks of 45 bytes: the checksum's odd last byte
    "earliest_fletcher32_uint8_odd": dict(chunks=(3, 5, 3), dtype="<u1",
                                          fletcher32=True),
    "latest_fletcher32_gzip": dict(libver="latest", chunks=C,
                                   fletcher32=True, compression="gzip"),
    # Fletcher-32 last in the pipeline, as h5py orders it (checked first
    # when decoding), and first, as a writer that sets it before the other
    # filters orders it (checked last, after shuffle or LZF;
    # HDF5 reads no file with it ahead of scale-offset)
    "earliest_shuffle_gzip_fletcher32": dict(chunks=C, shuffle=True,
                                             compression="gzip",
                                             fletcher32=True),
    "latest_shuffle_gzip_fletcher32": dict(libver="latest", chunks=C,
                                           shuffle=True, compression="gzip",
                                           fletcher32=True),
    "earliest_lzf_fletcher32": dict(chunks=C, compression="lzf",
                                    fletcher32=True),
    "latest_lzf_fletcher32": dict(libver="latest", chunks=C,
                                  compression="lzf", fletcher32=True),
    "earliest_fletcher32_first_shuffle_gzip": dict(
        chunks=C, shuffle=True, compression="gzip", fletcher32_first=True),
    "latest_fletcher32_first_shuffle": dict(libver="latest", chunks=C,
                                            shuffle=True,
                                            fletcher32_first=True),
    "earliest_fletcher32_first_lzf": dict(chunks=C, compression="lzf",
                                          fletcher32_first=True),
    "latest_fletcher32_first_lzf": dict(libver="latest", chunks=C,
                                        compression="lzf",
                                        fletcher32_first=True),
    "earliest_scaleoffset_int": dict(chunks=C, dtype="<i4", scaleoffset=0),
    "latest_scaleoffset_int_fill": dict(libver="latest", chunks=C,
                                        dtype="<i2", scaleoffset=0,
                                        fillvalue=-7, written=slice(0, 9)),
    "earliest_scaleoffset_float": dict(chunks=C, scaleoffset=3),
    "latest_scaleoffset_double_gzip": dict(libver="latest", chunks=C,
                                           dtype="<f8", scaleoffset=2,
                                           compression="gzip"),
    # stored types
    "earliest_float64": dict(dtype="<f8"),
    "earliest_float32_bigendian": dict(dtype=">f4"),
    "latest_float64_bigendian_shuffle_gzip": dict(
        libver="latest", dtype=">f8", chunks=C, shuffle=True,
        compression="gzip"),
    "earliest_float16": dict(dtype="<f2", chunks=C),
    "earliest_int16": dict(dtype="<i2"),
    "latest_int32_bigendian": dict(libver="latest", dtype=">i4", chunks=C),
    # the file around the dataset
    "h5md": dict(key=H5MD_KEY, h5md=True),
    "latest_h5md_chunked": dict(libver="latest", key=H5MD_KEY, h5md=True,
                                chunks=(1, 64, 3), maxshape=(None, 64, 3),
                                compression="gzip"),
    "earliest_soft_link": dict(link="soft"),
    "earliest_committed_datatype": dict(committed=True, chunks=C),
    "latest_soft_link": dict(libver="latest", link="soft"),
    "latest_dense_group": dict(libver="latest", dense=12),
    "earliest_track_order": dict(track_order=True, dense=12),
    "earliest_userblock": dict(userblock=512, chunks=C,
                               compression="gzip"),
    "latest_userblock": dict(libver="latest", userblock=512, chunks=C),
    "earliest_many_attributes": dict(attrs=40),
    "latest_many_attributes": dict(libver="latest", attrs=40,
                                   compact_attrs=True),
    "latest_swmr": dict(libver="latest", swmr=True, chunks=(2, 64, 3),
                        maxshape=(None, 64, 3), compression="gzip",
                        shuffle=True),
    # szip (libaec here): nearest-neighbour preprocessing or not, 8, 16
    # and 32 pixels per block, 16-, 32- and 64-bit pixels (the last two
    # coded as byte planes); chunks of 240 elements are 7.5 blocks of 32,
    # so their scan lines are padded
    **{f"earliest_szip_{mode}{ppb}_{dt[1:]}": dict(
        shape=S, dtype=dt, chunks=(5, 16, 3) if ppb == 32 else (4, 16, 3),
        compression="szip", compression_opts=(mode, ppb))
       for mode in ("nn", "ec") for ppb in (8, 16, 32)
       for dt in ("<i2", "<f4", "<f8")},
    "latest_szip_nn16_bigendian": dict(libver="latest", shape=S,
                                       dtype=">i2", chunks=(4, 16, 3),
                                       compression="szip",
                                       compression_opts=("nn", 16)),
    "latest_szip_ec8_uint8_shuffle": dict(libver="latest", shape=S,
                                          dtype="<u1", chunks=(4, 16, 3),
                                          shuffle=True, compression="szip",
                                          compression_opts=("ec", 8)),
    # n-bit: integers of fewer bits than their container, at an offset,
    # either byte order; floats of other layouts (h5py reads the 4-byte one
    # as float32, the 5-byte one as float64); full precision (stored as it
    # is: the filter's "no compression needed" flag)
    "earliest_nbit_int20_offset4": dict(shape=S, h5type="int20",
                                        chunks=(4, 16, 3), nbit=True),
    "latest_nbit_int20_bigendian": dict(libver="latest", shape=S,
                                        h5type="int20be",
                                        chunks=(4, 16, 3), nbit=True),
    "earliest_nbit_uint12": dict(shape=S, h5type="uint12",
                                 chunks=(4, 16, 3), nbit=True),
    "earliest_nbit_float25": dict(shape=S, h5type="float25",
                                  chunks=(4, 16, 3), nbit=True),
    "latest_nbit_float25_size5_gzip": dict(libver="latest", shape=S,
                                           h5type="float25x5",
                                           chunks=(4, 16, 3), nbit=True,
                                           deflate=4),
    "earliest_nbit_full_precision": dict(shape=S, chunks=(4, 16, 3),
                                         nbit=True),
    "earliest_nbit_float64_full_precision": dict(shape=S, dtype="<f8",
                                                 chunks=(4, 16, 3),
                                                 nbit=True),
    # those types without the filter
    "earliest_int20_contiguous": dict(shape=S, h5type="int20"),
    "latest_float25_compact": dict(libver="latest", shape=S,
                                   h5type="float25", layout="compact"),
    # a plugin filter (Blosc) set optional: h5py, without the plugin,
    # skipped it on every chunk (filter mask 1)
    "earliest_optional_plugin_skipped": dict(chunks=C, compression=32001,
                                             allow_unknown_filter=True),
    # messages in the file's shared-message heap: its index a list, and a
    # v2 B-tree
    "sohm_list": dict(shape=S, sohm="list", chunks=(4, 16, 3),
                      compression="gzip", shuffle=True, fillvalue=1.5),
    "sohm_btree": dict(shape=S, sohm="btree", chunks=(4, 16, 3),
                       fletcher32=True, fillvalue=-2.0),
    # refused by name, as the reference fails on them too: plugin filters
    # on chunks that were filtered (h5py here has no plugin to undo them),
    # and a compound type
    "refused_zstd": dict(shape=S, chunks=(4, 16, 3), plugin=32015),
    "refused_blosc": dict(shape=S, chunks=(4, 16, 3), plugin=32001),
    "refused_compound": dict(shape=S, compound=True),
}
REFUSED_FILTERS = {"refused_zstd": "zstd", "refused_blosc": "blosc"}
REFUSED = {**REFUSED_FILTERS, "refused_compound": "compound"}


# the numpy types the n-bit layouts' data are written from
_H5TYPE_DATA = {"int20": "<i4", "int20be": ">i4", "uint12": "<u2",
                "float25": "<f8", "float25x5": "<f8"}


def layout_data(name):
    """The frames a layout's dataset is written with, in its stored type
    (the n-bit layouts': in the numpy type h5py converts from)."""
    o = LAYOUTS[name]
    shape = o.get("shape", (N_FRAMES, 64, 3))
    if o.get("data") == "incompressible":
        a = incompressible(*shape[:2])
    else:
        a = frames(*shape[:2])
    if o.get("compound"):
        out = np.zeros(shape[:2], [("x", "<f4"), ("y", "<i4")])
        out["x"] = a[..., 0]
        return out
    h5type = o.get("h5type", "")
    dt = np.dtype(_H5TYPE_DATA.get(h5type, o.get("dtype", "<f4")))
    if dt.kind in "iu":
        a = np.round(a * (64 if dt.itemsize > 1 else 4))
        if h5type.startswith("int"):
            a -= 320                        # negative values: sign bits
    if h5type.startswith("float"):
        a[:, ::2] *= -1
    return a.astype(dt)


def _libhdf5(h5py):
    """h5py's own libhdf5, for what h5py does not expose."""
    import ctypes
    import glob
    libs = os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs",
                        "libhdf5-*")
    return ctypes.CDLL(next(p for p in glob.glob(libs) if "_hl" not in p))


def _h5type(h5py, name):
    """The stored datatypes of the n-bit layouts."""
    if name.startswith("float"):
        t = h5py.h5t.IEEE_F32LE.copy()
        # sign bit 31, an 8-bit exponent at bit 23 and a 16-bit mantissa at
        # bit 7 (positions count from the element's bit 0); the offset
        # grows the size to 5 bytes, which the 4-byte type takes back
        t.set_fields(31, 23, 8, 7, 16)
        t.set_offset(7)
        t.set_precision(25)
        if name == "float25":
            t.set_size(4)
        return t
    t = {"int20": h5py.h5t.STD_I32LE, "int20be": h5py.h5t.STD_I32BE,
         "uint12": h5py.h5t.STD_U16LE}[name].copy()
    if name == "uint12":
        t.set_precision(12)
    else:
        t.set_precision(20)
        t.set_offset(4)
    return t


def _sohm_fcpl(h5py, index):
    """A file creation property list whose shared-message table has two
    indices (dataspaces, datatypes and fill values; filter pipelines and
    attributes: bit n for message type n), each a list or (``index``
    ``'btree'``) a v2 B-tree from its first message on."""
    import ctypes
    lib = _libhdf5(h5py)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    pid = ctypes.c_int64(fcpl.id)
    assert lib.H5Pset_shared_mesg_nindexes(pid, ctypes.c_uint(2)) == 0
    for k, flags in enumerate((1 << 1 | 1 << 3 | 1 << 5, 1 << 11 | 1 << 12)):
        assert lib.H5Pset_shared_mesg_index(pid, ctypes.c_uint(k),
                                            ctypes.c_uint(flags),
                                            ctypes.c_uint(1)) == 0
    if index == "btree":
        assert lib.H5Pset_shared_mesg_phase_change(
            pid, ctypes.c_uint(0), ctypes.c_uint(0)) == 0
    return fcpl


def _plugin_chunk(fid, chunk):
    """A chunk as the plugin filter ``fid`` writes it: a Blosc frame (LZ4,
    byte shuffle) or a zstd frame."""
    if fid == 32001:
        from sitator_tpu_torch.io.zarr_store import blosc_encode
        return blosc_encode([np.ascontiguousarray(chunk)])[0]
    import ctypes
    zstd = ctypes.CDLL("libzstd.so.1")
    zstd.ZSTD_compress.restype = ctypes.c_size_t
    src = chunk.tobytes()
    dst = ctypes.create_string_buffer(len(src) + 1024)
    n = zstd.ZSTD_compress(dst, ctypes.c_size_t(len(dst)), src,
                           ctypes.c_size_t(len(src)), 3)
    return dst.raw[:n]


def _dcpl(h5py, o):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if o.get("layout") == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    if o.get("alloc") == "early":
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    if o.get("nbit"):
        dcpl.set_chunk(o["chunks"])
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0, ())
        if o.get("deflate"):
            dcpl.set_deflate(o["deflate"])
    if o.get("fletcher32_first"):
        dcpl.set_chunk(o["chunks"])
        dcpl.set_fletcher32()
    if o.get("compact_attrs"):
        dcpl.set_attr_phase_change(64, 48)
    if o.get("edges_not_filtered"):
        # h5py has no H5Pset_chunk_opts: call its own libhdf5
        import ctypes
        dcpl.set_chunk(o["chunks"])
        assert _libhdf5(h5py).H5Pset_chunk_opts(ctypes.c_int64(dcpl.id),
                                                ctypes.c_uint(2)) == 0
    return dcpl


def _h5md(f, n_frames):
    """The groups and attributes of an H5MD file around its positions."""
    f.attrs["creator"] = "tests._torch_h5_layouts"
    h5md = f.create_group("h5md")
    h5md.attrs["version"] = np.array([1, 1], np.int32)
    box = f.create_group("particles/all/box")
    box.attrs["dimension"] = 3
    box.attrs["boundary"] = np.array([b"periodic"] * 3)
    box["edges"] = np.full(3, 10.0)
    pos = f["particles/all/position"]
    pos["step"] = np.arange(n_frames, dtype=np.int64) * 10
    pos["time"] = np.arange(n_frames, dtype=np.float64) * 0.5
    f.create_group("observables")


def write(path, name):
    """Write layout ``name`` at ``path`` (the files of a layout of several
    beside it) with h5py; the frames the reference reads from it, as
    float32."""
    import h5py
    if name in MULTI:
        d = os.path.dirname(os.path.abspath(path))
        with _cwd(d):
            MULTI[name](h5py, os.path.basename(path), frames(N_FRAMES, 16)
                        .astype(np.float32))
            with h5py.File(path, "r") as f:
                return np.asarray(f[KEY][()], dtype=np.float32)
    o = LAYOUTS[name]
    data = layout_data(name)
    shape = data.shape
    key = o.get("key", KEY)
    fkw = dict(libver=(o.get("libver", "earliest"), "latest"))
    if o.get("userblock"):
        fkw["userblock_size"] = o["userblock"]
    if o.get("track_order"):
        fkw["track_order"] = True
    dkw = {k: o[k] for k in ("chunks", "maxshape", "compression",
                             "compression_opts", "shuffle", "fletcher32",
                             "scaleoffset", "fillvalue",
                             "allow_unknown_filter") if k in o}
    if o.get("swmr"):
        dkw["shape"] = (0, *shape[1:])
    written = o.get("written", slice(0, shape[0]))
    if o.get("sohm"):
        fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
        fapl.set_libver_bounds(h5py.h5f.LIBVER_EARLIEST,
                               h5py.h5f.LIBVER_LATEST)
        fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC,
                              fcpl=_sohm_fcpl(h5py, o["sohm"]), fapl=fapl)
        with h5py.File(fid) as f:
            # datasets and attributes of the same shapes, types and
            # filters: their messages are stored once, in the heap
            for k in range(3):
                d = f.create_dataset(f"other_{k}", data=data + k, **dkw)
                d.attrs["step"] = np.arange(4)
            d = f.create_dataset(key, data=data, **dkw)
            d.attrs["step"] = np.arange(4)
        with h5py.File(path, "r") as f:
            return np.asarray(f[key][()], dtype=np.float32)
    if o.get("plugin"):
        with h5py.File(path, "w", **fkw) as f:
            d = f.create_dataset(key, shape, data.dtype, chunks=o["chunks"],
                                 compression=o["plugin"],
                                 allow_unknown_filter=True)
            c0 = o["chunks"][0]
            for lo in range(0, shape[0], c0):
                d.id.write_direct_chunk((lo, 0, 0), _plugin_chunk(
                    o["plugin"], data[lo:lo + c0]), filter_mask=0)
        return None
    if o.get("compound"):
        with h5py.File(path, "w", **fkw) as f:
            f[key] = data
        return None
    if o.get("h5type"):
        with h5py.File(path, "w", **fkw) as f:
            dcpl = _dcpl(h5py, o)
            if o.get("chunks") and not o.get("nbit"):
                dcpl.set_chunk(o["chunks"])
            h5py.h5d.create(f.id, key.encode(), _h5type(h5py, o["h5type"]),
                            h5py.h5s.create_simple(shape), dcpl=dcpl)
            f[key][...] = data
        with h5py.File(path, "r") as f:
            return np.asarray(f[key][()], dtype=np.float32)
    with h5py.File(path, "w", **fkw) as f:
        if o.get("h5md"):
            f.create_group(key.rsplit("/", 1)[0])
        target = "data/frames" if o.get("link") else key
        if o.get("dense"):
            # a group of many links (long names: the link heap outgrows
            # its first block), the dataset the last of them
            g = f.create_group("many", track_order=o.get("track_order"))
            for k in range(o["dense"] - 1):
                g[f"{'link_%02d_' % k}{'x' * 240}"] = np.arange(k + 1)
            target = key = f"many/{KEY}"
        dtype = data.dtype
        if o.get("committed"):
            f["float_type"] = dtype          # a named, shared datatype
            dtype = f["float_type"]
        d = f.create_dataset(target, shape=dkw.pop("shape", shape),
                             dtype=dtype, dcpl=_dcpl(h5py, o), **dkw)
        if o.get("attrs"):
            # written after the data and another object, so the header
            # cannot grow in place: its messages spill into continuation
            # blocks
            d[written] = data[written]
            f["after"] = np.arange(3)
            for k in range(o["attrs"]):
                d.attrs[f"attribute_{k:02d}"] = np.arange(k + 4,
                                                          dtype=np.int64)
        if o.get("link") == "soft":
            f[key] = h5py.SoftLink("/" + target)
        if o.get("h5md"):
            _h5md(f, shape[0])
        if o.get("swmr"):
            f.swmr_mode = True
            for lo in range(0, shape[0], 3):
                hi = min(lo + 3, shape[0])
                d.resize(hi, axis=0)
                d[lo:hi] = data[lo:hi]
                f.flush()
        elif written.stop > written.start:
            d[written] = data[written]
    with h5py.File(path, "r") as f:
        return np.asarray(f[key][()], dtype=np.float32)


def key_of(name):
    """The key the reference opens in layout ``name``'s file."""
    o = LAYOUTS.get(name, {})
    return f"many/{KEY}" if o.get("dense") else o.get("key", KEY)


# ----------------------------------------------- layouts of several files
class _cwd:
    """Run in the directory ``d``, as HDF5 needs where it resolves a name
    against the working directory (external storage)."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        self.was = os.getcwd()
        os.chdir(self.d)

    def __exit__(self, *exc):
        os.chdir(self.was)


def _segments(h5py, data, names, key="x"):
    """``data`` split evenly over the files ``names``; the second file
    chunked (2 frames) with byte shuffle and deflate."""
    n = len(data) // len(names)
    for k, name in enumerate(names):
        kw = dict(chunks=(2, *data.shape[1:]), shuffle=True,
                  compression="gzip") if k == 1 else {}
        with h5py.File(name, "w") as f:
            f.create_dataset(key, data=data[k * n:(k + 1) * n], **kw)


def _virtual(h5py, path, data, maps, fill=None, libver="earliest"):
    """A virtual dataset of ``data``'s shape and type: ``maps`` is
    (virtual key, ``VirtualSource``) pairs."""
    lay = h5py.VirtualLayout(data.shape, data.dtype)
    for key, src in maps:
        lay[key] = src
    with h5py.File(path, "w", libver=(libver, "latest")) as f:
        f.create_virtual_dataset(KEY, lay, fillvalue=fill)


def _vds_segments(libver):
    def write_(h5py, path, data):
        names = [f"seg{k}.h5" for k in range(4)]
        _segments(h5py, data, names)
        _virtual(h5py, path, data, [
            (slice(4 * k, 4 * k + 4), h5py.VirtualSource(
                n, "x", (4, *data.shape[1:]))) for k, n in enumerate(names)],
            libver=libver)
    return write_


def _vds_self(h5py, path, data):
    """Sources named ``.``: two datasets of the virtual dataset's own
    file, mapped in reverse order."""
    with h5py.File(path, "w") as f:
        f["part0"], f["part1"] = data[8:], data[:8]
        lay = h5py.VirtualLayout(data.shape, data.dtype)
        lay[8:] = h5py.VirtualSource(".", "part0", (8, *data.shape[1:]))
        lay[:8] = h5py.VirtualSource(".", "part1", (8, *data.shape[1:]))
        f.create_virtual_dataset(KEY, lay)


def _vds_strided(h5py, path, data):
    """Interleaved: frames k, k + 4 of the first 8 from file k; the last 8
    from a chunked file of them in even-odd order, every other source frame
    to every other virtual frame."""
    shape = data.shape[1:]
    maps = []
    for k in range(4):
        with h5py.File(f"seg{k}.h5", "w") as f:
            f["x"] = data[k:8:4]
        maps.append((slice(k, 8, 4), h5py.VirtualSource(f"seg{k}.h5", "x",
                                                         (2, *shape))))
    with h5py.File("both.h5", "w") as f:
        f.create_dataset("x", data=np.concatenate([data[8::2], data[9::2]]),
                         chunks=(3, *shape), compression="gzip")
    src = h5py.VirtualSource("both.h5", "x", (8, *shape))
    maps += [(slice(8, 16, 2), src[0:4]), (slice(9, 16, 2), src[4:8])]
    _virtual(h5py, path, data, maps)


def _vds_unmapped(h5py, path, data):
    """Frames 6-9 mapped to nothing: the fill value."""
    _segments(h5py, data, ["seg0.h5", "seg1.h5"])
    shape = data.shape[1:]
    _virtual(h5py, path, data, [
        (slice(0, 6), h5py.VirtualSource("seg0.h5", "x", (8, *shape))[:6]),
        (slice(10, 16), h5py.VirtualSource("seg1.h5", "x",
                                           (8, *shape))[2:])], fill=-1.0)


def _vds_missing(h5py, path, data):
    """Frames 4-7 from a file that does not exist, 8-11 from a dataset
    that does not exist: the fill value."""
    _segments(h5py, data, ["seg0.h5", "seg1.h5"])
    shape = data.shape[1:]
    _virtual(h5py, path, data, [
        (slice(0, 4), h5py.VirtualSource("seg0.h5", "x", (8, *shape))[:4]),
        (slice(4, 8), h5py.VirtualSource("missing.h5", "x", (4, *shape))),
        (slice(8, 12), h5py.VirtualSource("seg1.h5", "nothing",
                                          (4, *shape))),
        (slice(12, 16), h5py.VirtualSource("seg1.h5", "x",
                                           (8, *shape))[4:])], fill=7.5)


def _vds_irregular(h5py, path, data):
    """A virtual selection that is a union of blocks of different widths
    (frames 0-3 whole, then half of frames 4-5), filled from 5 whole
    frames of the source in their order; under ``latest`` (selections of
    encoding version 3)."""
    with h5py.File("src.h5", "w") as f:
        f["x"] = data[:5]
    vspace = h5py.h5s.create_simple(data.shape)
    vspace.select_hyperslab((0, 0, 0), (4, 16, 3))
    vspace.select_hyperslab((4, 0, 0), (2, 8, 3), op=h5py.h5s.SELECT_OR)
    sspace = h5py.h5s.create_simple((5, 16, 3))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_virtual(vspace, b"src.h5", b"x", sspace)
    dcpl.set_fill_value(np.array(-3.0, np.float32))
    with h5py.File(path, "w", libver="latest") as f:
        h5py.h5d.create(f.id, KEY.encode(), h5py.h5t.IEEE_F32LE,
                        h5py.h5s.create_simple(data.shape), dcpl=dcpl)


def _extlink(h5py, path, data):
    with h5py.File("inner.h5", "w") as f:
        f.create_dataset("data/positions", data=data, chunks=(4, 16, 3),
                         compression="gzip")
    with h5py.File(path, "w") as f:
        f[KEY] = h5py.ExternalLink("inner.h5", "/data/positions")


def _extlink_chain(h5py, path, data):
    """An external link to a soft link to an external link, the last named
    relative to its own file's directory."""
    os.makedirs("sub", exist_ok=True)
    with h5py.File("sub/inner.h5", "w") as f:
        f[KEY] = data
    with h5py.File("mid.h5", "w", libver="latest") as f:
        f["b"] = h5py.ExternalLink("sub/inner.h5", "/" + KEY)
        f["a"] = h5py.SoftLink("/b")
    with h5py.File(path, "w") as f:
        f[KEY] = h5py.ExternalLink("mid.h5", "/a")


def _external_storage(h5py, path, data):
    """External storage in three segments of two files, at offsets other
    than 0 (each file starts with bytes that are not the data)."""
    n = data.nbytes // 4
    for name in ("raw0.bin", "raw1.bin"):
        with open(name, "wb") as f:
            f.write(b"header--" * 8)
    with h5py.File(path, "w") as f:
        d = f.create_dataset(KEY, data.shape, data.dtype, external=[
            ("raw0.bin", 64, n), ("raw1.bin", 24, 2 * n),
            ("raw0.bin", 64 + n, n)])
        d[...] = data


# layouts of several files, in a directory each: name -> writer(h5py,
# main file name, frames), run in that directory
MULTI = {
    "vds_segments": _vds_segments("earliest"),
    "vds_segments_latest": _vds_segments("latest"),
    "vds_self": _vds_self,
    "vds_strided": _vds_strided,
    "vds_unmapped": _vds_unmapped,
    "vds_missing": _vds_missing,
    "vds_irregular": _vds_irregular,
    "extlink": _extlink,
    "extlink_chain": _extlink_chain,
    "external_storage": _external_storage,
}
# the layouts whose files resolve against the working directory
CWD = ("external_storage",)


def path_of(name, root=FIXTURES):
    """The file the reference opens for layout ``name``."""
    if name in MULTI:
        return os.path.join(root, name, name + ".h5")
    return os.path.join(root, name + ".h5")


def cwd_of(name, root=FIXTURES):
    """The directory layout ``name`` is read from (None: any)."""
    return os.path.join(root, name) if name in CWD else None


# the frames ``chip_smoke.py``'s ``h5_passes`` reads through the three
# headers of ``bench_headers``: the bench config's 2048 frames twice over
BENCH = os.path.join(os.path.dirname(__file__), "data", "torch_h5_bench")
BENCH_SHAPE = (4096, 10000, 3)
BENCH_TURN = 128


def segment_frames(n_frames, k, turn=BENCH_TURN):
    """The frames (indices) ring segment ``k`` of 4 holds: a quarter of
    them from frame ``k * n_frames / 4 + turn`` on, round the end."""
    n = n_frames // 4
    return (np.arange(n) + k * n + turn) % n_frames


def bench_headers(out=BENCH, shape=BENCH_SHAPE, turn=BENCH_TURN):
    """Write, with h5py, the headers through which ``chip_smoke.py`` (whose
    machine has no h5py) reads frames of ``shape`` (float32, dataset
    ``positions``), the data beside them written by its own writers:

    - ``vds.h5``: a virtual dataset over the four segment files
      ``seg{k}.h5`` (``positions``, a quarter of the frames each), segment
      ``k`` holding ``segment_frames(n, k, turn)``: a ring turned by
      ``turn`` frames, so blocks cross segment borders (five mappings: the
      last segment's wraps round the end);
    - ``external.h5``: external storage in the four raw files
      ``seg{k}.bin`` (the frames in order, a quarter each, from offset 0),
      named relative to the working directory;
    - ``link.h5``: ``positions``, an external link to ``md_1.h5``'s."""
    import h5py
    os.makedirs(out, exist_ok=True)
    n, q = shape[0], shape[0] // 4
    lay = h5py.VirtualLayout(shape, np.float32)
    for k in range(4):
        src = h5py.VirtualSource(f"seg{k}.h5", KEY, (q, *shape[1:]))
        first = int(segment_frames(n, k, turn)[0])
        head = min(q, n - first)
        lay[first:first + head] = src[:head]
        if head < q:
            lay[:q - head] = src[head:]
    with h5py.File(os.path.join(out, "vds.h5"), "w") as f:
        f.create_virtual_dataset(KEY, lay)
    seg_bytes = q * math.prod(shape[1:]) * 4
    with h5py.File(os.path.join(out, "external.h5"), "w") as f:
        f.create_dataset(KEY, shape, np.float32, external=[
            (f"seg{k}.bin", 0, seg_bytes) for k in range(4)])
    with h5py.File(os.path.join(out, "link.h5"), "w") as f:
        f[KEY] = h5py.ExternalLink("md_1.h5", "/" + KEY)
    return out


def main(out=FIXTURES):
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    for name in [*LAYOUTS, *MULTI]:
        path = path_of(name, out)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        want = write(path, name)
        if want is not None:
            np.save(os.path.join(out, name + ".npy"), want)
    if out == FIXTURES:
        bench_headers()
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))
