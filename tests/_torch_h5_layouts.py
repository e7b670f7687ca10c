"""The HDF5 layouts ``h5py`` writes, for the port's reader
(``sitator_tpu_torch/io/h5_store.py``) to be held to.

``LAYOUTS`` maps a name to the options of one file: the ``libver`` bounds
(``earliest``: superblock v0, v1 object headers, old-style groups, layout
v3 with a v1 B-tree; ``v108``: superblock v2, v2 object headers, new-style
groups; ``latest``: superblock v3, layout v4 with its five chunk indices),
the dataset's storage (contiguous, compact or chunked, its filters, its
fill value, which frames are written) and the file's structure around it
(an H5MD path, a soft link, a dense group, creation order, a user block,
many attributes, SWMR).  Frames come from :func:`frames`: atoms on a
lattice, a quarter of them displaced in each frame by multiples of 1/64, so
every chunk compresses; ``incompressible`` layouts use random bytes
instead, which LZF stores raw.

``REFUSED`` names the layouts the port refuses by name (szip, n-bit).

Run ``python -m tests._torch_h5_layouts`` (with ``h5py``) to write every
layout as ``<name>.h5``, with what the reference's ``H5Trajectory`` reads
from it (cast to float32) as ``<name>.npy``, into
``tests/data/torch_h5_layouts/``: the fixtures ``chip_smoke.py`` reads on a
machine without ``h5py``.
"""
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
    # refused by name
    "refused_szip": dict(chunks=C, compression="szip",
                         compression_opts=("nn", 8)),
    "refused_nbit": dict(chunks=C, nbit=True),
}
REFUSED = {"refused_szip": "szip", "refused_nbit": "n-bit"}


def layout_data(name):
    """The frames a layout's dataset is written with, in its stored
    type."""
    o = LAYOUTS[name]
    shape = o.get("shape", (N_FRAMES, 64, 3))
    if o.get("data") == "incompressible":
        a = incompressible(*shape[:2])
    else:
        a = frames(*shape[:2])
    dt = np.dtype(o.get("dtype", "<f4"))
    if dt.kind in "iu":
        a = np.round(a * (64 if dt.itemsize > 1 else 4))
    return a.astype(dt)


def _dcpl(h5py, o):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if o.get("layout") == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    if o.get("alloc") == "early":
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    if o.get("nbit"):
        dcpl.set_chunk(o["chunks"])
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0, ())
    if o.get("fletcher32_first"):
        dcpl.set_chunk(o["chunks"])
        dcpl.set_fletcher32()
    if o.get("compact_attrs"):
        dcpl.set_attr_phase_change(64, 48)
    if o.get("edges_not_filtered"):
        # h5py has no H5Pset_chunk_opts: call its own libhdf5
        import ctypes
        import glob
        libs = os.path.join(os.path.dirname(h5py.__file__), "..",
                            "h5py.libs", "libhdf5-*")
        lib = ctypes.CDLL(next(p for p in glob.glob(libs) if "_hl" not in p))
        dcpl.set_chunk(o["chunks"])
        assert lib.H5Pset_chunk_opts(ctypes.c_int64(dcpl.id),
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
    """Write layout ``name`` at ``path`` with h5py; the frames the
    reference reads from it, as float32."""
    import h5py
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
                             "scaleoffset", "fillvalue") if k in o}
    if o.get("swmr"):
        dkw["shape"] = (0, *shape[1:])
    written = o.get("written", slice(0, shape[0]))
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
    o = LAYOUTS[name]
    return f"many/{KEY}" if o.get("dense") else o.get("key", KEY)


def main(out=FIXTURES):
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    for name in LAYOUTS:
        want = write(os.path.join(out, name + ".h5"), name)
        np.save(os.path.join(out, name + ".npy"), want)
    return out


if __name__ == "__main__":
    print(main(*sys.argv[1:]))
