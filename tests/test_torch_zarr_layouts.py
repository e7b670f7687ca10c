"""Every zarr v2 / zarr v3 / n5 layout ``tensorstore`` writes on a ``file``
kvstore, read by the port (``io/zarr_store.py``, ``io/native/zarrcodec.cpp``)
with ``tensorstore`` blocked, against the reference's
``TensorstoreTrajectory``.

The layouts are ``tests/_torch_zarr_layouts.py``'s: zarr v2 zstd, bz2 and
Blosc (blosclz, lz4, lz4hc, zlib, zstd x shuffle 0/1/2, and -1 in F order),
zarr v3 zstd (with and without checksum), crc32c, transpose, Blosc with each
shuffle and ``sharding_indexed`` (index at the end and at the start, nested,
an absent inner chunk and a missing shard), n5 bzip2, xz, zstd and Blosc.
Every Blosc frame in them is compressed (none a memcpy frame).  Each is
written anew by the ``tensorstore`` installed here and held bit for bit to
the reference, whole and over ranges that cut chunks and shards; the
committed fixtures (``tests/data/torch_zarr_layouts/``, what
``chip_smoke.py`` reads on the card) are held to ``tensorstore`` and the
port.  Also: crc32c mismatches raise naming the chunk, a sharded read
reads only the index and the inner chunks it needs, a streaming pass from a
sharded zstd store equals the pass from memory, ``chip_smoke.py``'s own
writers make stores both readers read bit-equal, and every refusal left in
the metadata parsers names what it refuses.  Every comparison is exact.
"""
import contextlib
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest

ts = pytest.importorskip("tensorstore")

from sitator_tpu.io import tensorstore_io as ref_ts  # noqa: E402

from sitator_tpu_torch.io import tensorstore_io as port_ts  # noqa: E402
from sitator_tpu_torch.io import zarr_store  # noqa: E402

from tests import _torch_zarr_layouts as layouts  # noqa: E402

NAMES = sorted(layouts.LAYOUTS)


def keys(n):
    """``test_reference_store_reads_bit_equal``'s keys: whole, ranges that
    cut chunks and shards, strided, single frames."""
    return (slice(0, n), slice(1, n - 1), slice(n // 3, n // 2 + 1),
            slice(n - 1, n), slice(1, n, 3), 0, n - 1, 3)


def read_ts(path, driver):
    spec = {"driver": driver, "kvstore": {"driver": "file", "path": path}}
    return ts.open(spec, read=True).result()[...].read().result()


@contextlib.contextmanager
def blocked(monkeypatch):
    """A context in which ``import tensorstore`` fails."""
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "tensorstore", None)
        yield


@pytest.mark.parametrize("name", NAMES)
def test_layout_reads_bit_equal_without_tensorstore(tmp_path, monkeypatch,
                                                    name):
    path = str(tmp_path / name)
    want_frames = layouts.write(path, name)
    driver = layouts.LAYOUTS[name][0]
    if "blosc" in name:
        flags = layouts.blosc_flags(path)
        assert flags and not any(f & 0x02 for f in flags), flags
    ref = ref_ts.TensorstoreTrajectory(path)
    n = len(ref)
    want = {str(k): ref[k] for k in keys(n)}
    native = read_ts(path, driver)
    np.testing.assert_array_equal(native, want_frames)
    with blocked(monkeypatch):
        got = port_ts.TensorstoreTrajectory(path)
        assert got._ts is None and len(got) == n
        for k in keys(n):
            g = got[k]
            assert g.dtype == np.float32 and g.shape == want[str(k)].shape
            np.testing.assert_array_equal(g, want[str(k)], err_msg=str(k))
        store = zarr_store.ZarrArray(path)
        for lo, hi in ((0, n), (1, n - 1), (3, 9), (5, 6)):
            g = store.read(lo, hi, native.dtype)
            assert g.tobytes() == native[lo:hi].tobytes(), (lo, hi)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_tensorstore_and_the_port(name):
    """The committed fixture still holds what ``tensorstore`` reads from
    it, and the port reads the same."""
    path = os.path.join(layouts.FIXTURES, name)
    want = np.load(path + ".npy")
    driver = layouts.LAYOUTS[name][0]
    native = read_ts(path, driver)
    assert native.dtype == want.dtype
    assert native.tobytes() == want.tobytes()
    got = zarr_store.ZarrArray(path).read(0, len(want), want.dtype)
    assert got.tobytes() == want.tobytes()
    if "blosc" in name:
        assert not any(f & 0x02 for f in layouts.blosc_flags(path))


def test_fixtures_are_every_layout_and_small():
    names = {f for f in os.listdir(layouts.FIXTURES)
             if os.path.isdir(os.path.join(layouts.FIXTURES, f))}
    assert names == set(layouts.LAYOUTS)
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(layouts.FIXTURES) for f in fs)
    assert size < 1 << 20, size


def _fixture_copy(tmp_path, name):
    path = str(tmp_path / name)
    shutil.copytree(os.path.join(layouts.FIXTURES, name), path)
    return path


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("name,chunk,offset,named", [
    ("v3_crc32c", "c/1/0/0", 100, "c/1/0/0"),
    ("v3_transpose_zstd_crc32c", "c/2/0/0", -2, "c/2/0/0"),
    ("v3_sharded_zstd", "c/1/0/0", -10, "c/1/0/0 (shard index)"),
], ids=["chunk", "chunk_checksum", "shard_index"])
def test_crc32c_mismatch_raises_naming_the_chunk(tmp_path, name, chunk,
                                                 offset, named):
    path = _fixture_copy(tmp_path, name)
    f = os.path.join(path, *chunk.split("/"))
    _flip(f, offset if offset >= 0 else os.path.getsize(f) + offset)
    store = zarr_store.ZarrArray(path)
    np.testing.assert_array_equal(store.read(0, 4), layouts.frames()[:4])
    with pytest.raises(ValueError, match="crc32c mismatch") as e:
        store.read(0, 16)
    assert named in str(e.value)


def test_crc32c_known_answers():
    assert zarr_store.crc32c(b"123456789") == 0xE3069283
    assert zarr_store.crc32c(b"") == 0
    from chip_smoke import crc32c_py
    data = np.random.default_rng(0).integers(0, 256, 300, dtype=np.uint8)
    assert zarr_store.crc32c(data) == crc32c_py(data.tobytes())


def test_absent_inner_chunk_and_missing_shard_read_as_fill(tmp_path):
    path = os.path.join(layouts.FIXTURES, "v3_sharded_absent")
    assert not os.path.exists(os.path.join(path, "c", "1", "0", "0"))
    with open(os.path.join(path, "c", "0", "0", "0"), "rb") as f:
        index = np.frombuffer(f.read()[-36:-4], "<u8").reshape(2, 2)
    assert (index[1] == 2 ** 64 - 1).all() and index[0, 1] > 0
    store = zarr_store.ZarrArray(path)
    a = layouts.frames()
    np.testing.assert_array_equal(store.read(0, 4), a[:4])
    assert (store.read(4, 16) == 7.5).all()
    assert (store.read(6, 11) == 7.5).all()
    # an inner chunk the index marks present is never read as the fill:
    # in a shard cut short before its index, it raises
    path = _fixture_copy(tmp_path, "v3_sharded_absent")
    shard = os.path.join(path, "c", "0", "0", "0")
    with open(shard, "rb") as f:
        blob = f.read()
    with open(shard, "wb") as f:
        f.write(blob[:100] + blob[-36:])
    with pytest.raises(ValueError, match="past the end"):
        zarr_store.ZarrArray(path).read(0, 4)


def test_sharded_read_reads_only_the_index_and_the_inner_chunks_it_needs(
        monkeypatch):
    path = os.path.join(layouts.FIXTURES, "v3_sharded_zstd")
    ranges, indexes = [], []
    read_range = zarr_store.ZarrArray._read_range
    read_index = zarr_store.ZarrArray._read_index
    monkeypatch.setattr(zarr_store.ZarrArray, "_read_range",
                        lambda self, *a: ranges.append(a[:3])
                        or read_range(self, *a))
    monkeypatch.setattr(zarr_store.ZarrArray, "_read_index",
                        lambda self, s: indexes.append(s)
                        or read_index(self, s))
    store = zarr_store.ZarrArray(path)
    want = layouts.frames()
    np.testing.assert_array_equal(store.read(8, 12), want[8:12])
    shard = store.chunk_path((1, 0, 0))
    assert indexes == [(1, 0, 0)]
    assert len(ranges) == 1 and ranges[0][0] == shard
    assert 0 < ranges[0][2] < (os.path.getsize(shard)
                               - store._shard.index_nbytes)
    ranges.clear()
    indexes.clear()
    np.testing.assert_array_equal(store.read(2, 14), want[2:14])
    assert sorted(indexes) == [(0, 0, 0), (1, 0, 0)]
    assert len(ranges) == 4 and all(r[1] is not None for r in ranges)


def test_streaming_pass_from_sharded_zstd_store_equals_memory(tmp_path):
    from sitator_tpu_torch import SiteNetwork, StreamingLandmarkAnalysis
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator
    from sitator_tpu_torch.io import (ArrayTrajectory,
                                      make_hopping_trajectory,
                                      open_trajectory)
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=300,
                                 jump_rate=0.03, seed=9)
    traj = md.traj.astype(np.float32)
    path = str(tmp_path / "md.zarr")
    meta = layouts._v3([layouts._shard(
        [layouts._bytes(), layouts._zstd(level=1)],
        chunks=(32, traj.shape[1], 3))], chunks=(128, traj.shape[1], 3))
    meta["shape"] = list(traj.shape)
    ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": path},
             "metadata": meta}, create=True).result().write(traj).result()
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0, verbose=False,
              device="cpu", block_frames=64)
    results = []
    for src in (ArrayTrajectory(traj), open_trajectory(path)):
        eng = StreamingLandmarkAnalysis(
            store_labels=str(tmp_path / f"{len(results)}.npy"), **kw)
        centers = eng.fit_centers(seeds, src)
        got = eng.run(seeds, src, centers=centers)
        results.append((centers, np.load(eng.store_labels), got.n_ij))
    assert type(src) is port_ts.TensorstoreTrajectory and src._ts is None
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["sharded_zstd", "blosc_zstd_bitshuffle"])
def test_chip_smoke_writers_read_bit_equal_through_both(tmp_path,
                                                        monkeypatch, writer):
    """``chip_smoke.py``'s stores (its own zstd, bitshuffle, Blosc frames
    and shard index with crc32c): ``tensorstore`` and the port read them
    bit-equal; 70 frames in shards of 32 leave the last shard's last inner
    chunks absent, chunks of 8 frames an edge chunk, 739 atoms a Blosc
    block whose element count is a multiple of 8."""
    import chip_smoke
    a = np.concatenate([layouts.frames(739, seed=s) for s in range(5)])[:70]
    path = str(tmp_path / "s.zarr")
    if writer == "sharded_zstd":
        chip_smoke.write_sharded_zstd_store(path, a, shard=32, inner=8)
        driver = "zarr3"
    else:
        chip_smoke.write_blosc_zstd_bitshuffle_store(path, a, chunk=8)
        driver = "zarr"
        assert layouts.blosc_flags(path) == {0x94}
    np.testing.assert_array_equal(read_ts(path, driver), a)
    with blocked(monkeypatch):
        store = zarr_store.ZarrArray(path)
        for lo, hi in ((0, 70), (5, 67), (60, 70), (33, 34)):
            assert store.read(lo, hi).tobytes() == a[lo:hi].tobytes()


def test_bitshuffle_matches_the_codecs_inverse():
    """``chip_smoke.bitshuffle_blocks`` is undone by the native codec (a
    Blosc frame whose one block is stored raw: only the bit transpose)."""
    from chip_smoke import bitshuffle_blocks
    rng = np.random.default_rng(1)
    for ts_, ne in ((4, 64), (8, 1024), (1, 4096), (2, 8)):
        raw = rng.integers(0, 256, ts_ * ne, dtype=np.uint8)
        shuffled = bitshuffle_blocks(raw[None], ts_)[0]
        frame = (bytes([2, 1, 0x10 | 0x04 | (1 << 5), ts_])
                 + struct.pack("<3i", raw.size, raw.size,
                               16 + 4 + 4 + raw.size)
                 + struct.pack("<ii", 20, raw.size) + shuffled.tobytes())
        out = np.empty_like(raw)
        zarr_store.blosc_decode([np.frombuffer(frame, np.uint8)], [out])
        assert out.tobytes() == raw.tobytes(), (ts_, ne)


def _meta(tmp_path, name, fmt, meta):
    path = tmp_path / name
    path.mkdir()
    (path / {"zarr": ".zarray", "zarr3": "zarr.json",
             "n5": "attributes.json"}[fmt]).write_text(json.dumps(meta))
    return str(path)


def _v2_meta(**kw):
    return {"zarr_format": 2, "shape": [8, 4, 3], "chunks": [4, 4, 3],
            "dtype": "<f4", "compressor": None, "fill_value": 0,
            "order": "C", "filters": None, **kw}


def _v3_meta(**kw):
    return {"zarr_format": 3, "node_type": "array", "shape": [8, 4, 3],
            "data_type": "float32", "fill_value": 0.0,
            "chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": [4, 4, 3]}},
            "codecs": [{"name": "bytes"}], **kw}


def _sharded(**kw):
    cfg = {"chunk_shape": [2, 4, 3], "codecs": [{"name": "bytes"}],
           "index_codecs": [{"name": "bytes"}, {"name": "crc32c"}], **kw}
    return _v3_meta(codecs=[{"name": "sharding_indexed",
                             "configuration": cfg}])


REFUSALS = {
    "v2_filters": ("zarr", _v2_meta(filters=[{"id": "delta"}]),
                   "filters are not supported: 'delta'"),
    "v2_compressor": ("zarr", _v2_meta(compressor={"id": "lzma"}),
                      "compressor 'lzma' is not supported"),
    "v2_blosc_cname": ("zarr", _v2_meta(compressor={
        "id": "blosc", "cname": "lizard", "shuffle": 1}),
        "Blosc compressor 'lizard' is not supported"),
    "v2_dtype": ("zarr", _v2_meta(dtype="<c8"), "data type '<c8'"),
    "v2_order": ("zarr", _v2_meta(order="K"), "order 'K'"),
    "v3_chunk_grid": ("zarr3", _v3_meta(chunk_grid={
        "name": "rectilinear", "configuration": {}}),
        "chunk grid 'rectilinear' is not supported"),
    "v3_storage_transformers": ("zarr3", _v3_meta(storage_transformers=[
        {"name": "chunk-manifest-json"}]),
        "storage transformers are not supported: 'chunk-manifest-json'"),
    "v3_codec": ("zarr3", _v3_meta(codecs=[{"name": "bytes"},
                                           {"name": "lz4"}]),
                 "codec 'lz4' is not supported"),
    "v3_no_bytes": ("zarr3", _v3_meta(codecs=[{"name": "transpose",
                                               "configuration": {
                                                   "order": [0, 1, 2]}}]),
                    "without bytes or sharding_indexed"),
    "v3_transpose_order": ("zarr3", _v3_meta(codecs=[
        {"name": "transpose", "configuration": {"order": [0, 0, 1]}},
        {"name": "bytes"}]), r"order \[0, 0, 1\] is not a permutation"),
    "v3_fill_value": ("zarr3", _v3_meta(fill_value="0x7fc00000"),
                      "fill_value '0x7fc00000'"),
    "v3_key_encoding": ("zarr3", _v3_meta(chunk_key_encoding={
        "name": "suffix"}), "chunk key encoding 'suffix'"),
    "v3_shard_shape": ("zarr3", _sharded(chunk_shape=[3, 4, 3]),
                       r"chunk_shape \[3, 4, 3\] does not divide"),
    "v3_shard_index_codecs": ("zarr3", _sharded(index_codecs=[
        {"name": "bytes"}, {"name": "gzip"}]),
        r"index_codecs \['bytes', 'gzip'\] are not supported"),
    "v3_shard_index_location": ("zarr3", _sharded(index_location="middle"),
                                "index_location 'middle'"),
    "v3_blosc_cname": ("zarr3", _v3_meta(codecs=[{"name": "bytes"}, {
        "name": "blosc", "configuration": {"cname": "lizard"}}]),
        "Blosc compressor 'lizard'"),
    "n5_compression": ("n5", {"dimensions": [8, 4, 3], "blockSize": [4, 4, 3],
                              "dataType": "float32",
                              "compression": {"type": "lz4"}},
                       "n5 compression 'lz4' is not supported"),
    "n5_dtype": ("n5", {"dimensions": [8, 4, 3], "blockSize": [4, 4, 3],
                        "dataType": "complex64"}, "data type 'complex64'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_parser_refusals_name_what_they_do_not_read(tmp_path, case):
    fmt, meta, message = REFUSALS[case]
    path = _meta(tmp_path, case, fmt, meta)
    with pytest.raises(zarr_store.UnsupportedLayout, match=message):
        zarr_store.ZarrArray(path)


MALFORMED = {
    "v2_zarr_format": ("zarr", _v2_meta(zarr_format=3),
                       ".zarray zarr_format 3"),
    "v3_group": ("zarr3", _v3_meta(node_type="group"),
                 "zarr.json is not a zarr v3 array"),
    "chunk_rank": ("zarr", _v2_meta(chunks=[4, 4]),
                   r"chunk shape \(4, 4\) does not fit"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_metadata_raises_naming_it(tmp_path, case):
    fmt, meta, message = MALFORMED[case]
    path = _meta(tmp_path, case, fmt, meta)
    with pytest.raises(ValueError, match=message) as e:
        zarr_store.ZarrArray(path)
    assert not isinstance(e.value, zarr_store.UnsupportedLayout)
    with pytest.raises(ValueError, match="is not a zarr/zarr3/n5 array"):
        zarr_store.ZarrArray(str(tmp_path))


def test_malformed_chunks_raise_at_read(tmp_path):
    """A shard too short for its index, an n5 block of another rank."""
    path = _meta(tmp_path, "sharded", "zarr3", _sharded())
    os.makedirs(os.path.join(path, "c", "0", "0"))
    with open(os.path.join(path, "c", "0", "0", "0"), "wb") as f:
        f.write(b"\0" * 10)
    with pytest.raises(ValueError, match="cannot hold its 36-byte index"):
        zarr_store.ZarrArray(path).read(0, 4)
    path = _meta(tmp_path, "n5", "n5", {
        "dimensions": [8, 4, 3], "blockSize": [4, 4, 3],
        "dataType": "float32", "compression": {"type": "raw"}})
    os.makedirs(os.path.join(path, "0", "0"))
    with open(os.path.join(path, "0", "0", "0"), "wb") as f:
        f.write(struct.pack(">HH2I", 0, 2, 4, 12) + b"\0" * 192)
    with pytest.raises(ValueError, match="block of 2 dimensions"):
        zarr_store.ZarrArray(path).read(0, 4)


def test_n5_block_mode_refused_at_read(tmp_path):
    path = _meta(tmp_path, "n5", "n5", {
        "dimensions": [8, 4, 3], "blockSize": [4, 4, 3],
        "dataType": "float32", "compression": {"type": "raw"}})
    os.makedirs(os.path.join(path, "0", "0"))
    with open(os.path.join(path, "0", "0", "0"), "wb") as f:
        f.write(struct.pack(">HH3I", 2, 3, 4, 4, 3) + b"\0" * 192)
    with pytest.raises(zarr_store.UnsupportedLayout, match="block mode 2"):
        zarr_store.ZarrArray(path).read(0, 4)


def test_census_of_codec_libraries():
    have = zarr_store.codec_libraries()
    assert set(have) == set(zarr_store.LIBRARIES)
    assert all(have.values()), have


def _snappy_plain(data):
    """Raw Snappy decoded the plain way: the varint length, then literals
    and copies one byte at a time."""
    n = shift = p = 0
    while True:
        b = data[p]
        p += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while p < len(data):
        tag = data[p]
        p += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                w = length - 59
                length = int.from_bytes(data[p:p + w], "little")
                p += w
            out += data[p:p + length + 1]
            p += length + 1
            continue
        if kind == 1:
            length, off = 4 + (tag >> 2 & 7), (tag >> 5) << 8 | data[p]
            p += 1
        else:
            w = 2 if kind == 2 else 4
            length, off = (tag >> 2) + 1, int.from_bytes(data[p:p + w],
                                                          "little")
            p += w
        for _ in range(length):
            out.append(out[-off])
    assert len(out) == n
    return bytes(out)


def _snappy_streams(path):
    """The Snappy streams of the first block of each Blosc frame of a
    store (those not stored raw)."""
    out = []
    for name in sorted(os.listdir(path)):
        if name.startswith("."):
            continue
        with open(os.path.join(path, name), "rb") as f:
            frame = f.read()
        nbytes, blocksize = struct.unpack("<ii", frame[4:12])
        at = struct.unpack("<i", frame[16:20])[0]
        nsplits = 1 if frame[2] & 0x10 else frame[3]
        for _ in range(nsplits):
            size = struct.unpack("<i", frame[at:at + 4])[0]
            if size != min(blocksize, nbytes) // nsplits:
                out.append(frame[at + 4:at + 4 + size])
            at += 4 + size
    return out


def test_snappy_known_answers():
    """The hand-written Snappy decoder against a plain one: on the streams
    of the Blosc-snappy fixtures (tensorstore's c-blosc wrote them), and on
    streams made here with every element kind (literals with lengths in
    the tag and in 1-4 more bytes; copies with 1-, 2- and 4-byte offsets,
    overlapping their output); cut, or with a copy reaching before the
    start, it raises."""
    streams = []
    for shuffle in (0, 1, 2):
        streams += _snappy_streams(os.path.join(
            layouts.FIXTURES, f"v2_blosc_snappy_{shuffle}"))
    assert len(streams) > 10
    lit = bytes(range(256)) * 300
    def varint(n):
        out = bytearray()
        while n >= 0x80:
            out.append(n & 0x7F | 0x80)
            n >>= 7
        return bytes(out + bytes([n]))
    made = [
        varint(5) + b"\x10hello",
        varint(263) + bytes([61 << 2]) + (255).to_bytes(2, "little")
        + lit[:256] + bytes([1 | 3 << 2 | 1 << 5, 0x00]),
        varint(10) + b"\x08abc" + bytes([2 | 6 << 2])
        + (3).to_bytes(2, "little"),
        varint(9) + b"\x00z" + bytes([3 | 7 << 2]) + (1).to_bytes(4, "little"),
        varint(70128) + bytes([62 << 2]) + (70000 - 1).to_bytes(3, "little")
        + lit[:70000] + bytes([3 | 63 << 2]) + (65536).to_bytes(4, "little")
        + bytes([2 | 63 << 2]) + (64).to_bytes(2, "little"),
        varint(2048) + bytes([63 << 2]) + (2047).to_bytes(4, "little")
        + lit[:2048],
    ]
    for data in streams + made:
        want = _snappy_plain(data)
        assert zarr_store.snappy_decode(data, len(want)) == want
        with pytest.raises(ValueError, match="Snappy"):
            zarr_store.snappy_decode(data[:-1], len(want))
        with pytest.raises(ValueError, match="Snappy"):
            zarr_store.snappy_decode(data, len(want) - 1)
    with pytest.raises(ValueError, match="Snappy"):
        zarr_store.snappy_decode(b"\x05" + bytes([1 | 1 << 2, 0x02]), 5)
