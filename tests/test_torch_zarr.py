"""The port's zarr stores (``io/zarr_store.py`` and the native codec
``io/native/zarrcodec.cpp``, no zarr library) against ``tensorstore`` and
the reference's ``convert_to_zarr`` / ``TensorstoreTrajectory``; every
other layout tensorstore writes is in ``test_torch_zarr_layouts.py``.

Stores written by ``tensorstore`` (zarr v2 with blosc/LZ4, zarr v3 raw,
n5 with blosc, gzip or no compression; float32 and float64; chunks of 1, 4
and 512 frames, the last larger than one Blosc block; an edge chunk;
random frames, whose small chunks Blosc stores as memcpy frames, and
constant frames, which compress) read bit-equal through the port; the
port's stores read bit-equal through the reference, with metadata equal
as JSON to what the reference writes for the same call.  Every array
comparison here is exact.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest

ts = pytest.importorskip("tensorstore")

from sitator_tpu.io import tensorstore_io as ref_ts  # noqa: E402
from sitator_tpu.io.formats import ArrayTrajectory as RefArray  # noqa: E402

from sitator_tpu_torch.io import tensorstore_io as port_ts  # noqa: E402
from sitator_tpu_torch.io import zarr_store  # noqa: E402
from sitator_tpu_torch.io.formats import ArrayTrajectory  # noqa: E402

CHUNKS = (1, 4, 512)
METADATA = {2: ".zarray", 3: "zarr.json"}


def frames(kind, chunk, dtype, seed=0):
    """(F, A, 3) frames of float32 values (readers hand over float32), as
    ``dtype``: an edge chunk at every chunk size."""
    n, a = (600, 100) if chunk == 512 else (10, 7)
    if kind == "constant":
        return np.full((n, a, 3), 1.25, dtype)
    return np.random.default_rng(seed).normal(size=(n, a, 3)).astype(
        np.float32).astype(dtype)


def read_ts(path, driver):
    spec = {"driver": driver, "kvstore": {"driver": "file", "path": path}}
    return ts.open(spec, read=True).result()[...].read().result()


def blosc_flags(path):
    """The header flags of every Blosc frame in a store directory."""
    flags = set()
    for root, _, files in os.walk(path):
        for f in files:
            if f in (".zarray", "zarr.json", "attributes.json") or \
                    f.endswith(".npz"):
                continue
            with open(os.path.join(root, f), "rb") as fh:
                head = fh.read(32)
            if path.endswith("n5"):
                nd = struct.unpack(">H", head[2:4])[0]
                head = head[4 + 4 * nd:]
            flags.add(head[2])
    return flags


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zarr_format", [2, 3])
def test_reference_store_reads_bit_equal(tmp_path, zarr_format, dtype,
                                         chunk, kind):
    """A store the reference's ``convert_to_zarr`` writes (through
    tensorstore) reads bit-equal through the port, whole and in ranges that
    cut chunks; the sidecar structure comes back."""
    a = frames(kind, chunk, dtype)
    out = str(tmp_path / "ref.zarr")
    ref_ts.convert_to_zarr(RefArray(a), out, dtype=dtype, chunk_frames=chunk,
                           zarr_format=zarr_format)
    store = zarr_store.ZarrArray(out)
    assert store.format == ("zarr3" if zarr_format == 3 else "zarr")
    np.testing.assert_array_equal(store.read(0, len(a), dtype), a)
    got = port_ts.TensorstoreTrajectory(out)
    want = ref_ts.TensorstoreTrajectory(out)
    assert len(got) == len(want) == len(a)
    n = len(a)
    for key in (slice(0, n), slice(1, n - 1), slice(n // 3, n // 2 + 1),
                slice(n - 1, n), slice(1, n, 3), 0, n - 1, 3):
        g, w = got[key], want[key]
        assert g.dtype == np.float32 and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=str(key))
    # numpy's own indexing where tensorstore has none: negative
    np.testing.assert_array_equal(got[-1], want[n - 1])
    np.testing.assert_array_equal(got[::-4], want[slice(0, n)][::-4])
    with pytest.raises(IndexError):
        got[n]
    if zarr_format == 2 and dtype == np.float32:
        flags = blosc_flags(out)
        # Blosc stores chunks under 128 bytes and random 4-frame chunks as
        # memcpy frames; the others compress
        memcpy = {f for f in flags if f & 0x02}
        expect = chunk == 1 or (kind == "random" and chunk == 4)
        assert memcpy if expect else not memcpy, flags


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("compression", ["blosc", "gzip", "raw"])
def test_n5_store_reads_bit_equal(tmp_path, compression, dtype, chunk, kind):
    """n5 written by tensorstore (big-endian, column-major blocks)."""
    a = frames(kind, chunk, dtype, seed=1)
    comp = {"blosc": {"type": "blosc", "cname": "lz4", "clevel": 5,
                      "shuffle": 1},
            "gzip": {"type": "gzip"}, "raw": {"type": "raw"}}[compression]
    out = str(tmp_path / "traj.n5")
    arr = ts.open({"driver": "n5",
                   "kvstore": {"driver": "file", "path": out},
                   "metadata": {"dimensions": list(a.shape),
                                "blockSize": [chunk, a.shape[1], 3],
                                "dataType": np.dtype(dtype).name,
                                "compression": comp}},
                  create=True, delete_existing=True).result()
    arr.write(a).result()
    store = zarr_store.ZarrArray(out)
    assert store.format == "n5"
    np.testing.assert_array_equal(store.read(0, len(a), dtype), a)
    np.testing.assert_array_equal(store.read(1, len(a) - 2, dtype),
                                  a[1:len(a) - 2])
    np.testing.assert_array_equal(port_ts.TensorstoreTrajectory(out)[:],
                                  a.astype(np.float32))


@pytest.mark.parametrize("codecs", [
    [{"name": "bytes", "configuration": {"endian": "big"}}],
    [{"name": "bytes", "configuration": {"endian": "little"}},
     {"name": "gzip", "configuration": {"level": 5}}],
    [{"name": "bytes", "configuration": {"endian": "little"}},
     {"name": "blosc", "configuration": {"cname": "lz4", "clevel": 5,
                                         "shuffle": "shuffle",
                                         "typesize": 4}}],
], ids=["big_endian", "gzip", "blosc"])
@pytest.mark.parametrize("encoding", ["default", "v2"])
def test_zarr3_codecs_and_key_encodings(tmp_path, codecs, encoding):
    a = frames("random", 4, np.float32, seed=2)
    out = str(tmp_path / "v3.zarr")
    ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": out},
             "metadata": {"shape": list(a.shape), "data_type": "float32",
                          "chunk_grid": {"name": "regular", "configuration":
                                         {"chunk_shape": [4, 7, 3]}},
                          "chunk_key_encoding": {"name": encoding},
                          "codecs": codecs}},
            create=True, delete_existing=True).result().write(a).result()
    np.testing.assert_array_equal(zarr_store.ZarrArray(out).read(0, 10), a)
    np.testing.assert_array_equal(zarr_store.ZarrArray(out).read(3, 9),
                                  a[3:9])


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 3},
                                        {"id": "gzip", "level": 3}],
                         ids=["none", "zlib", "gzip"])
@pytest.mark.parametrize("order", ["C", "F"])
def test_zarr2_compressors_orders_and_chunked_atoms(tmp_path, compressor,
                                                    order):
    """zarr v2 without a compressor, with zlib and gzip, in either order,
    and chunked along the atoms as well; a chunk that was never written
    reads as the fill value."""
    a = frames("random", 4, np.float64, seed=3)
    out = str(tmp_path / "v2.zarr")
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "file", "path": out},
                   "metadata": {"shape": list(a.shape), "chunks": [3, 4, 2],
                                "dtype": "<f8", "order": order,
                                "compressor": compressor,
                                "fill_value": 7.5}},
                  create=True, delete_existing=True).result()
    arr[:8].write(a[:8]).result()
    want = a.copy()
    want[8:] = 7.5
    got = zarr_store.ZarrArray(out)
    np.testing.assert_array_equal(got.read(0, 10, np.float64), want)
    np.testing.assert_array_equal(got.read(2, 9, np.float64), want[2:9])


@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zarr_format", [2, 3])
def test_port_store_reads_bit_equal_through_reference(
        tmp_path, zarr_format, dtype, chunk, kind):
    """The port's ``convert_to_zarr`` store: metadata equal as JSON to the
    reference's for the same call, and bit-equal through the reference's
    ``TensorstoreTrajectory`` and through tensorstore at its own dtype."""
    a = frames(kind, chunk, dtype, seed=4)
    kw = dict(dtype=dtype, chunk_frames=chunk, zarr_format=zarr_format,
              block_frames=8)
    ours, theirs = str(tmp_path / "port.zarr"), str(tmp_path / "ref.zarr")
    port_ts.convert_to_zarr(ArrayTrajectory(a), ours, **kw)
    ref_ts.convert_to_zarr(RefArray(a), theirs, **kw)
    name = METADATA[zarr_format]
    with open(os.path.join(ours, name)) as f, \
            open(os.path.join(theirs, name)) as g:
        assert json.load(f) == json.load(g)
    want = ref_ts.TensorstoreTrajectory(theirs)[:]
    np.testing.assert_array_equal(ref_ts.TensorstoreTrajectory(ours)[:],
                                  want)
    driver = "zarr3" if zarr_format == 3 else "zarr"
    got = read_ts(ours, driver)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, a)


def test_convert_text_and_sidecar_through_both(tmp_path):
    """An XYZ file converted by the port (the native decoder's route and the
    two-pass route of ``variable_cell='rescale'``) reads through the
    reference with its structure sidecar."""
    from sitator_tpu_torch.io import write_xyz
    from tests._torch_common import networks_of  # noqa: F401 -- conftest
    from sitator_tpu_torch.io import make_fcc_hopping_trajectory
    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=4,
                                     n_frames=23, jump_rate=0.1, seed=2)
    xyz = str(tmp_path / "md.xyz")
    write_xyz(xyz, md.structure, md.traj)
    for vc in ("error", "rescale"):
        out = str(tmp_path / f"{vc}.zarr")
        port_ts.convert_to_zarr(xyz, out, chunk_frames=5, zarr_format=2,
                                variable_cell=vc)
        got = ref_ts.TensorstoreTrajectory(out)
        np.testing.assert_array_equal(
            got[:], port_ts.TensorstoreTrajectory(out)[:])
        np.testing.assert_allclose(got[:], md.traj, atol=1e-5)
        np.testing.assert_array_equal(got.structure.species,
                                      md.structure.species)


def _frame(flags, typesize=4, payload=b"\0" * 64):
    return (bytes([2, 1, flags, typesize])
            + struct.pack("<3i", 256, 256, 16 + 4 + 4 + len(payload))
            + struct.pack("<i", 20) + struct.pack("<i", len(payload))
            + payload)


def _blosc_chunk(tmp_path, cname, shuffle=1):
    """The first chunk file of a zarr v2 store that tensorstore writes with
    Blosc ``cname`` (compressible frames), and the frames it holds."""
    from tests._torch_zarr_layouts import frames as lattice_frames
    a = lattice_frames()
    out = str(tmp_path / f"{cname}.zarr")
    ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": out},
             "metadata": {"shape": list(a.shape), "chunks": [4, 64, 3],
                          "dtype": "<f4", "compressor": {
                              "id": "blosc", "cname": cname, "clevel": 5,
                              "shuffle": shuffle}}},
            create=True).result().write(a).result()
    with open(os.path.join(out, "0.0.0"), "rb") as f:
        frame = np.frombuffer(f.read(), np.uint8)
    assert not frame[2] & 0x02            # compressed, not a memcpy frame
    return frame, a[:4]


@pytest.mark.parametrize("code,name", [(4, "zstd"), (0, "blosclz"),
                                       (3, "zlib"), (2, "snappy")])
def test_other_blosc_compressors_raise_naming_them(tmp_path, code, name):
    """A real Blosc frame of each compressor but LZ4 (tensorstore's):
    zstd, blosclz, zlib and snappy decode to the frames written; the same
    frame marked with a compressor code c-blosc 1.x does not have (5-7)
    raises, naming the code."""
    frame, want = _blosc_chunk(tmp_path, name)
    assert (frame[2] >> 5) & 7 == code
    out = np.zeros_like(want)
    zarr_store.blosc_decode([frame], [out])
    np.testing.assert_array_equal(out, want)
    other = frame.copy()
    other[2] = (other[2] & 0x1F) | (5 + code % 3) << 5
    with pytest.raises(ValueError, match=f"'code {5 + code % 3}' is not "
                       "supported"):
        zarr_store.blosc_decode([other], [out])


def test_bitshuffle_and_corrupt_frames_raise(tmp_path):
    """A bitshuffled frame (tensorstore's, LZ4) decodes; a corrupt, a
    truncated and a wrong-size frame raise."""
    frame, want = _blosc_chunk(tmp_path, "lz4", shuffle=2)
    assert frame[2] & 0x04
    got = np.zeros_like(want)
    zarr_store.blosc_decode([frame], [got])
    np.testing.assert_array_equal(got, want)
    out = np.zeros(64, np.float32)
    # an LZ4 stream that claims a match before the start of the block
    bad = _frame(1 << 5 | 0x10, payload=bytes([0x0F, 0x05, 0x00]) + b"\0" * 61)
    with pytest.raises(ValueError, match="corrupt LZ4"):
        zarr_store.blosc_decode([np.frombuffer(bad, np.uint8)], [out])
    good = zarr_store.blosc_encode([np.arange(64, dtype=np.float32)])[0]
    with pytest.raises(ValueError, match="truncated"):
        zarr_store.blosc_decode([np.frombuffer(good[:-3], np.uint8)], [out])
    with pytest.raises(ValueError, match="another size"):
        zarr_store.blosc_decode([np.frombuffer(good, np.uint8)],
                                [np.zeros(65, np.float32)])


def test_unsupported_store_layouts_raise_naming_them(tmp_path, monkeypatch):
    """What the port still refuses, at open, naming it: a v2 ``filters``
    store; ``zstd`` where libzstd.so.1 does not load (with tensorstore
    installed it reads through it, bit-equal to the reference; without it
    it raises ``ValueError``).  Blosc ``snappy``, once refused, reads on
    the port's own codec without tensorstore, bit-equal to the
    reference."""
    from tests._torch_zarr_layouts import frames as lattice_frames
    a = lattice_frames()
    flt = str(tmp_path / "filters.zarr")
    os.makedirs(flt)
    with open(os.path.join(flt, ".zarray"), "w") as f:
        json.dump({"zarr_format": 2, "shape": [16, 64, 3],
                   "chunks": [4, 64, 3], "dtype": "<f4", "compressor": None,
                   "fill_value": 0, "order": "C",
                   "filters": [{"id": "delta", "dtype": "<f4"}]}, f)
    stores = {}
    for name, comp in (("snappy", {"id": "blosc", "cname": "snappy",
                                   "clevel": 5, "shuffle": 1}),
                       ("zstd", {"id": "zstd", "level": 1})):
        stores[name] = out = str(tmp_path / f"{name}.zarr")
        ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                               "path": out},
                 "metadata": {"shape": list(a.shape), "chunks": [4, 64, 3],
                              "dtype": "<f4", "compressor": comp}},
                create=True).result().write(a).result()
    usable = zarr_store.library_usable
    monkeypatch.setattr(zarr_store, "library_usable",
                        lambda lib: lib != "libzstd.so.1" and usable(lib))
    with pytest.raises(zarr_store.UnsupportedLayout,
                       match="filters are not supported: 'delta'"):
        zarr_store.ZarrArray(flt)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(ValueError, match="filters.*tensorstore, which "
                           "would read it, is not installed"):
            port_ts.TensorstoreTrajectory(flt)
        snappy = port_ts.TensorstoreTrajectory(stores["snappy"])
        assert snappy._ts is None
        with pytest.raises(ValueError, match="'zstd' needs libzstd.so.1"):
            port_ts.TensorstoreTrajectory(stores["zstd"])
    for name, out in stores.items():
        got = port_ts.TensorstoreTrajectory(out)
        assert (got._ts is None) == (name == "snappy"), name
        want = ref_ts.TensorstoreTrajectory(out)
        for key in (slice(0, 16), slice(3, 9), 5):
            np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="not a zarr"):
        port_ts.TensorstoreTrajectory(str(tmp_path))


def test_file_spec_is_read_without_tensorstore_and_others_need_it(
        tmp_path, monkeypatch):
    a = frames("random", 4, np.float32)
    out = str(tmp_path / "s.zarr")
    port_ts.convert_to_zarr(ArrayTrajectory(a), out, chunk_frames=4)
    monkeypatch.setattr(port_ts, "_ts", lambda: pytest.fail(
        "tensorstore opened for a local store"))
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": out}}
    np.testing.assert_array_equal(port_ts.TensorstoreTrajectory(spec)[:], a)
    np.testing.assert_array_equal(
        port_ts.TensorstoreTrajectory(dict(spec, kvstore="file://" + out))[
            2:5], a[2:5])
    with pytest.raises(ValueError, match="transform"):
        port_ts.TensorstoreTrajectory(dict(spec, transform={}))
    # another kvstore goes to tensorstore (an empty memory store: its
    # "not found" is tensorstore's own)
    opened = []
    monkeypatch.setattr(port_ts, "_ts", lambda: opened.append(1) or ts)
    with pytest.raises(ValueError, match="NOT_FOUND"):
        port_ts.TensorstoreTrajectory({"driver": "zarr",
                                       "kvstore": {"driver": "memory"}})
    assert opened == [1]


@pytest.mark.parametrize("typesize", [1, 2, 4, 8, 32])
def test_codec_round_trips(typesize):
    """Encode and decode across block sizes (one block, several, a
    leftover block, split and unsplit streams, memcpy frames)."""
    rng = np.random.default_rng(typesize)
    dt = np.dtype([("b", np.uint8, typesize)])
    for n_items in (1, 3, 40, 1000, 70_001, 300_000):
        walk = np.cumsum(rng.integers(-2, 3, n_items * typesize),
                         dtype=np.int64).astype(np.uint8)
        for raw in (walk, rng.integers(0, 256, n_items * typesize,
                                       dtype=np.uint8)):
            arr = raw.view(dt)
            frame = zarr_store.blosc_encode([arr])[0]
            assert len(frame) <= arr.nbytes + 16
            back = np.empty_like(arr)
            zarr_store.blosc_decode([np.frombuffer(frame, np.uint8)],
                                    [back])
            assert back.tobytes() == arr.tobytes()
