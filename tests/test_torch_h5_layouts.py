"""Every HDF5 layout of ``tests/_torch_h5_layouts.py``, read by the port's
own reader (``io/h5_store.py``, ``io/native/h5codec.cpp``) against the
reference's ``H5Trajectory`` through ``h5py``.

The layouts cover ``libver`` earliest, v108 and latest; contiguous, compact
and chunked storage with every chunk index (v1 B-tree, single chunk,
implicit, fixed array paged and not, extensible array past its index
block, v2 B-tree one and two levels deep); unallocated chunks with a fill
value; gzip 1 and 9, shuffle, LZF (compressible, and incompressible, which
h5py stores raw under filter mask 1), Fletcher-32 (alone, with gzip, and
last or first in the pipeline beside shuffle or LZF), scale-offset on
integers and floats, szip (every option h5py sets), n-bit (integers and
floats of reduced precision at an offset, full precision), an optional
plugin filter every chunk skipped, partial edge chunks stored unfiltered;
float64, big-endian, float16, integer and custom-layout data; an H5MD
path, soft and external links, dense groups, creation order, a user
block, continuation blocks, SWMR, shared messages; virtual datasets
(segments, a ``.`` source, strided, unmapped, missing sources, unions of
blocks) and external storage, each in a directory of its files.  Each is
written anew by the h5py installed here and held bit for bit to the
reference over whole, cut, strided and single-frame reads; the committed
fixtures (what ``chip_smoke.py`` reads on the card) are held to h5py and
the port, and their chunk lists to h5py's ``get_chunk_info``; chunks kept
for partly read ranges stay right while later chunks decode.  Also:
errors keep h5py's types; the szip and n-bit decoders hold to the chunks
libhdf5 wrote; file names resolve as HDF5 resolves them; plugin filters,
compound types and unlimited virtual mappings are refused by name (the
first two fail in the reference too), and the native filters without the
native codec; a paged extensible array reads as h5py reads it; with
``h5py`` and ``tensorstore`` unimportable the port reads every other
fixture and streams from five HDF5 inputs; and ``chip_smoke.py``'s own
writers make files both readers read equal.  Every comparison is exact.
"""
import math
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from sitator_tpu.io import formats as ref_formats  # noqa: E402

from sitator_tpu_torch.io import formats as port_formats  # noqa: E402
from sitator_tpu_torch.io import h5_store  # noqa: E402

from tests import _torch_h5_layouts as layouts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(layouts.FIXTURES)
NAMES = sorted([*layouts.LAYOUTS, *layouts.MULTI])
READ = [n for n in NAMES if n not in layouts.REFUSED]
CHUNKED = [n for n in READ if "chunks" in layouts.LAYOUTS.get(n, {})]


def keys(n):
    """The keys every layout is read with: whole, cut, single frames from
    either end, strided, and a cut over two axes."""
    return (slice(0, n), slice(3, 9), 0, -1, 5 % n, slice(None, None, 3),
            (slice(2, 9), slice(5, 17)), (1, slice(None), 2))


def h5_chunks(path, key):
    """h5py's chunk info (``chunk_iter``, as ``get_chunk_info`` gives it)
    of every chunk, sorted by offset."""
    infos = []
    with h5py.File(path, "r") as f:
        f[key].id.chunk_iter(infos.append)
    return sorted((tuple(int(x) for x in c.chunk_offset), int(c.byte_offset),
                   int(c.size), int(c.filter_mask)) for c in infos)


def assert_reads_equal(path, key, cwd=None):
    with layouts._cwd(cwd or os.getcwd()):
        port = port_formats.H5Trajectory(str(path), key)
        ref = ref_formats.H5Trajectory(str(path), key)
        _held_to(port, ref)


def _held_to(port, ref):
    try:
        assert port._h5py is None
        assert len(port) == len(ref) and port.n_atoms == ref.n_atoms
        for k in keys(len(ref)):
            got, want = port[k], ref[k]
            assert got.dtype == want.dtype == np.float32, k
            assert got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("name", READ)
def test_layout_written_anew_reads_bit_equal(tmp_path, name):
    path = layouts.path_of(name, str(tmp_path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    want = layouts.write(path, name)
    cwd = layouts.cwd_of(name, str(tmp_path))
    assert_reads_equal(path, layouts.key_of(name), cwd)
    with layouts._cwd(cwd or os.getcwd()):
        got = h5_store.H5Dataset(path, layouts.key_of(name))
        assert got.read(0, len(want)).tobytes() == want.tobytes()
        got.close()


@pytest.mark.parametrize("name", READ)
def test_fixture_equals_h5py_and_the_port(name):
    """The committed fixture read by h5py equals its ``.npy`` and the
    port's read; the port's dtype is the one h5py reads it as."""
    path = layouts.path_of(name)
    want = np.load(FIXTURES / f"{name}.npy")
    key, cwd = layouts.key_of(name), layouts.cwd_of(name)
    with layouts._cwd(cwd or os.getcwd()), h5py.File(path, "r") as f:
        assert np.asarray(f[key][()], np.float32).tobytes() == want.tobytes()
        ds = h5_store.H5Dataset(path, key)
        assert ds.dtype == f[key].dtype and ds.shape == f[key].shape
        assert ds.fill_value.tobytes() == np.asarray(
            f[key].fillvalue, ds.dtype).tobytes()
        ds.close()
    assert_reads_equal(path, key, cwd)


@pytest.mark.parametrize("name", CHUNKED)
def test_chunk_list_equals_h5py(name):
    path = layouts.path_of(name)
    key = layouts.key_of(name)
    got = h5_store.H5Dataset(str(path), key).chunk_info()
    assert got == h5_chunks(path, key) and got


def test_fixtures_are_every_layout_and_small():
    """A layout of one file is ``<name>.h5``, one of several a directory
    ``<name>/`` holding ``<name>.h5`` and the files it names; every layout
    the reference reads has ``<name>.npy``.  Every file, in the
    directories too, counts towards the 3 MB."""
    assert sorted(p.stem for p in FIXTURES.glob("*.h5")) == sorted(
        layouts.LAYOUTS)
    assert sorted(p.name for p in FIXTURES.iterdir() if p.is_dir()) == \
        sorted(layouts.MULTI)
    assert sorted(p.stem for p in FIXTURES.glob("*.npy")) == READ
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")
               if p.is_file()) < 3_000_000
    # what the fixtures are there to reach
    formats = {}
    for name in READ:
        with h5py.File(layouts.path_of(name), "r") as f:
            formats[f.id.get_create_plist().get_version()[0]] = name
    assert sorted(formats) == [0, 2, 3]
    indices = {h5_store.H5Dataset(layouts.path_of(n),
                                  layouts.key_of(n)).index for n in CHUNKED}
    assert indices == {"v1 B-tree", "single chunk", "implicit",
                       "fixed array", "extensible array", "v2 B-tree"}
    # LZF stores incompressible chunks raw, under filter mask 1
    for name in ("earliest_lzf_incompressible", "latest_lzf_incompressible",
                 "earliest_optional_plugin_skipped"):
        masks = {m for *_, m in h5_store.H5Dataset(
            str(FIXTURES / f"{name}.h5")).chunk_info()}
        assert masks == {1}
    # shared messages in the heap, of the table's two indices
    for name in ("sohm_list", "sohm_btree"):
        f = h5_store._File(layouts.path_of(name), h5_store._Files())
        shared = {t for t, flags, body in f.messages(f.resolve(layouts.KEY)[1])
                  if flags & 2 and body[:2] == b"\x03\x01"}
        assert {1, 3, 5, 11} <= shared, name
        f.close()
    # virtual selections: all, regular hyperslabs (encoded as blocks under
    # earliest), unions of blocks that are no product; n-bit stored as it
    # is under full precision; szip scan lines padded, 32- and 64-bit
    # pixels as byte planes
    kinds = set()
    for name in READ:
        ds = h5_store.H5Dataset(layouts.path_of(name), layouts.key_of(name))
        if ds.layout == "virtual":
            for m in ds.mappings:
                kinds |= {m.source_sel[0], m.virtual_sel[0]}
        for fid, _, cd in ds.filters:
            if fid == 5:
                kinds.add(("n-bit stored as is", bool(cd[1])))
            if fid == 4:
                kinds.add(("szip padded", bool(cd[3] % cd[1])))
                kinds.add(("szip bits", int(cd[2])))
        ds.close()
    assert kinds >= {"all", "regular", "blocks", ("n-bit stored as is", 1),
                     ("n-bit stored as is", 0), ("szip padded", 1),
                     ("szip padded", 0), ("szip bits", 16),
                     ("szip bits", 32), ("szip bits", 64)}


def test_errors_keep_h5pys_types(tmp_path):
    path = str(FIXTURES / "earliest_gzip1.h5")
    for mod in (ref_formats, port_formats):
        with pytest.raises(KeyError):
            mod.H5Trajectory(path, "nothing/here")
        with pytest.raises(KeyError):
            mod.H5Trajectory(path, "positions/deeper")
        r = mod.H5Trajectory(path)
        for k in (16, -17, (0, 64), (0, 0, 3)):
            with pytest.raises(IndexError):
                r[k]
        for k in (slice(None, None, -1), slice(0, 4, 0), (0, 0, 0, 0)):
            with pytest.raises(ValueError):
                r[k]
        r.close()
    not_h5 = tmp_path / "text.h5"
    not_h5.write_text("positions\n" * 200)
    with pytest.raises(OSError):
        h5_store.H5Dataset(str(not_h5))


@pytest.mark.parametrize("name", ["earliest_fletcher32",
                                  "latest_fletcher32_gzip",
                                  "latest_fletcher32_first_shuffle"])
def test_fletcher32_mismatch_raises_oserror(tmp_path, name):
    path = tmp_path / f"{name}.h5"
    shutil.copy(FIXTURES / f"{name}.h5", path)
    offset, at, size, _ = h5_chunks(path, "positions")[5]
    data = bytearray(path.read_bytes())
    data[at + size // 2] ^= 0x10
    path.write_bytes(bytes(data))
    lo = offset[0]
    for mod in (ref_formats, port_formats):
        r = mod.H5Trajectory(str(path))
        with pytest.raises(OSError):
            r[lo:lo + 4]
        np.testing.assert_array_equal(r[0:4], np.load(
            FIXTURES / f"{name}.npy")[0:4])     # other chunks still read
        r.close()


def test_fletcher32_known_answers():
    """The native sum against HDF5's algorithm written out in Python (16-bit
    big-endian words, an odd last byte as the high byte of a last word),
    over lengths around its 360-word blocks."""
    def plain(b):
        s1 = s2 = 0
        words = len(b) // 2
        for lo in range(0, words, 360):
            for i in range(lo, min(lo + 360, words)):
                s1 += b[2 * i] << 8 | b[2 * i + 1]
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(b) % 2:
            s1 += b[-1] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return s2 << 16 | s1
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 3, 719, 720, 721, 5000, 5001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert h5_store.fletcher32(data) == plain(data), n
    assert h5_store.fletcher32(b"\xff" * 4000) == plain(b"\xff" * 4000)


def _chunks_as_stored(name):
    """(client data of the fixture's n-bit or szip filter, then for each
    chunk its stored bytes and what HDF5 decodes of it, read with the file's
    own type as the memory type: the chunk's elements as stored, no
    conversion; an edge chunk only inside the dataset, as a slice)."""
    path = layouts.path_of(name)
    out = []
    with h5py.File(path, "r") as f:
        d = f[layouts.KEY]
        fid = {4, 5} & {d.id.get_create_plist().get_filter(k)[0]
                        for k in range(d.id.get_create_plist()
                                       .get_nfilters())}
        k = [d.id.get_create_plist().get_filter(k)[0] for k in range(
            d.id.get_create_plist().get_nfilters())].index(fid.pop())
        cd = np.asarray(d.id.get_create_plist().get_filter(k)[2], np.uint32)
        tid = d.id.get_type()
        for off, *_ in h5_chunks(path, layouts.KEY):
            _, raw = d.id.read_direct_chunk(off)
            count = tuple(min(c, n - o) for c, n, o in zip(
                d.chunks, d.shape, off))
            space = d.id.get_space()
            space.select_hyperslab(off, count)
            arr = np.empty(count, f"V{tid.get_size()}")
            d.id.read(h5py.h5s.create_simple(count), space, arr, mtype=tid)
            out.append((raw, arr))
        return cd, d.chunks, tid.get_size(), out


def _native(fn, raw, n, cd):
    """(status, output) of a native chunk decoder into ``n`` bytes."""
    src = np.frombuffer(raw, np.uint8).copy()
    dst = np.zeros(max(n, 1), np.uint8)
    status = getattr(h5_store._codec(), fn)(
        src.ctypes.data, src.size, dst.ctypes.data, n, cd.ctypes.data,
        cd.size)
    return int(status), dst[:n]


@pytest.mark.parametrize("fn,name", [
    ("h5c_szip_decode", "earliest_szip_nn8_i2"),
    ("h5c_szip_decode", "earliest_szip_ec32_f4"),
    ("h5c_szip_decode", "earliest_szip_nn32_f8"),
    ("h5c_szip_decode", "latest_szip_nn16_bigendian"),
    ("h5c_szip_decode", "earliest_szip_ec16_f8"),
    ("h5c_nbit_decode", "earliest_nbit_int20_offset4"),
    ("h5c_nbit_decode", "latest_nbit_int20_bigendian"),
    ("h5c_nbit_decode", "earliest_nbit_float25"),
    ("h5c_nbit_decode", "earliest_nbit_full_precision")])
def test_chunk_decoders_known_answers(fn, name):
    """``h5c_szip_decode`` and ``h5c_nbit_decode`` on every chunk libaec
    and libhdf5 wrote, against what HDF5 decodes of it; cut short, each
    returns a negative status, and a thousand corrupted copies decode or
    fail without crashing."""
    cd, chunks, size, got = _chunks_as_stored(name)
    n = math.prod(chunks) * size
    rng = np.random.default_rng(5)
    for raw, want in got:
        status, out = _native(fn, raw, n, cd)
        assert status == 0
        region = tuple(slice(0, c) for c in want.shape)
        assert out.view(f"V{size}").reshape(chunks)[region].tobytes() == \
            want.tobytes()
        assert _native(fn, raw[:len(raw) // 2], n, cd)[0] < 0
    for raw, _ in got[:4]:
        assert _native(fn, raw[:3], n, cd)[0] < 0
        assert _native(fn, raw, n - size, cd)[0] < 0
        for _ in range(250):
            bad = bytearray(raw)
            for at in rng.integers(0, len(bad), 3):
                bad[at] = int(rng.integers(0, 256))
            assert isinstance(_native(fn, bytes(bad), n, cd)[0], int)


@pytest.mark.parametrize("name,filt",
                         sorted(layouts.REFUSED_FILTERS.items()))
def test_refused_filters_are_named(name, filt, monkeypatch):
    """A plugin filter on chunks it filtered: the port refuses it by name;
    h5py here (no plugin) fails to read it too, so the port's last resort
    fails as the reference does."""
    path = str(FIXTURES / f"{name}.h5")
    with pytest.raises(h5_store.UnsupportedLayout, match=filt):
        h5_store.H5Dataset(path)
    for mod in (ref_formats, port_formats):
        r = mod.H5Trajectory(path)
        with pytest.raises(OSError):
            r[:]
        r.close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(h5_store.UnsupportedLayout,
                       match=f"{filt}.*h5py, which may read it"):
        port_formats.H5Trajectory(path)


def test_filters_needing_the_native_codec_refused_without_it(monkeypatch):
    """Without g++ the native codec is not built: shuffle, LZF,
    Fletcher-32, scale-offset, szip and n-bit are refused by name when the
    dataset is opened, and deflate alone (Python's zlib) still reads."""
    monkeypatch.setattr(h5_store, "_codec", lambda: None)
    for name, filt in (("earliest_shuffle_gzip", "shuffle"),
                       ("earliest_lzf", "lzf"),
                       ("earliest_fletcher32", "fletcher32"),
                       ("earliest_scaleoffset_int", "scale-offset"),
                       ("earliest_szip_nn8_f4", "szip"),
                       ("earliest_nbit_uint12", "n-bit")):
        with pytest.raises(h5_store.UnsupportedLayout,
                           match=f"{filt} needs the native codec"):
            h5_store.H5Dataset(str(FIXTURES / f"{name}.h5"))
    got = h5_store.H5Dataset(str(FIXTURES / "earliest_gzip9.h5")).read(0, 16)
    assert got.tobytes() == np.load(FIXTURES / "earliest_gzip9.npy").tobytes()


def _external_link(tmp_path):
    path = tmp_path / "outer.h5"
    with h5py.File(tmp_path / "inner.h5", "w") as f:
        f["positions"] = layouts.frames(2, 4).astype(np.float32)
    with h5py.File(path, "w") as f:
        f["positions"] = h5py.ExternalLink("inner.h5", "/positions")
    return path


def _virtual(tmp_path):
    path = tmp_path / "virtual.h5"
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f["x"] = layouts.frames(2, 4).astype(np.float32)
    lay = h5py.VirtualLayout((2, 4, 3), np.float32)
    lay[:] = h5py.VirtualSource(str(tmp_path / "src.h5"), "x", (2, 4, 3))
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("positions", lay)
    return path


def _external_storage(tmp_path):
    path = tmp_path / "external.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("positions", (2, 4, 3), np.float32,
                         external=[(str(tmp_path / "raw.bin"), 0, 96)])
        f["positions"][...] = layouts.frames(2, 4)
    return path


def _plugin_filter(tmp_path):
    path = tmp_path / "plugin.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("positions", (4, 4, 3), np.float32, chunks=True,
                             compression=32015, allow_unknown_filter=True)
        d.id.write_direct_chunk((0, 0, 0), b"\0" * 24, filter_mask=0)
    return path


def _compound(tmp_path):
    path = tmp_path / "compound.h5"
    with h5py.File(path, "w") as f:
        f["positions"] = np.zeros((2, 4), [("x", "<f4"), ("y", "<i4")])
    return path


@pytest.mark.parametrize("make", [_external_link, _virtual,
                                  _external_storage])
def test_features_once_refused_read_as_h5py(tmp_path, make):
    """An external link, a virtual dataset and external storage (absolute
    names), once refused by name, read as the reference reads them."""
    path = make(tmp_path)
    assert_reads_equal(path, "positions")


@pytest.mark.parametrize("make,named", [(_plugin_filter, "zstd"),
                                        (_compound, "compound")])
def test_features_left_out_are_refused_by_name(tmp_path, make, named):
    with pytest.raises(h5_store.UnsupportedLayout, match=named):
        h5_store.H5Dataset(str(make(tmp_path)))


@pytest.mark.parametrize("make,error", [(_plugin_filter, OSError),
                                        (_compound, (TypeError, ValueError))])
def test_reference_fails_on_what_the_port_refuses(tmp_path, make, error):
    """What the port refuses the reference cannot read either: h5py has
    no plugin for the filter, and numpy makes no float32 of a compound."""
    r = ref_formats.H5Trajectory(str(make(tmp_path)))
    with pytest.raises(error):
        r[:]
    r.close()


def test_unlimited_virtual_mapping_refused_by_name(tmp_path):
    """An unlimited mapping (a source that grows, h5s.UNLIMITED on both
    sides) h5py reads; the port refuses it by name, and its last resort
    is h5py."""
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f.create_dataset("x", data=layouts.frames(6, 4).astype(np.float32),
                         maxshape=(None, 4, 3))
    lay = h5py.VirtualLayout((6, 4, 3), np.float32, maxshape=(None, 4, 3))
    src = h5py.VirtualSource("src.h5", "x", (6, 4, 3),
                             maxshape=(None, 4, 3))
    lay[:h5py.h5s.UNLIMITED] = src[:h5py.h5s.UNLIMITED]
    path = str(tmp_path / "grows.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("positions", lay)
    with h5py.File(path, "r") as f:
        want = np.asarray(f["positions"][()], np.float32)
    assert want.tobytes() == layouts.frames(6, 4).astype(
        np.float32).tobytes()
    with pytest.raises(h5_store.UnsupportedLayout, match="unlimited"):
        h5_store.H5Dataset(path)
    r = port_formats.H5Trajectory(path)
    assert r._h5py is not None and r[:].tobytes() == want.tobytes()
    r.close()


@pytest.mark.parametrize("name", ["extlink", "extlink_chain", "vds_segments",
                                  "vds_missing", "external_storage"])
def test_names_resolve_as_hdf5_resolves_them(tmp_path, name):
    """Opened from another working directory, beside h5py: external links
    and virtual sources resolve against the parent file's directory, so
    they read the same; external storage resolves against the working
    directory, so both fail with ``OSError``."""
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    path = layouts.path_of(name)
    with layouts._cwd(str(elsewhere)):
        if name not in layouts.CWD:
            assert_reads_equal(path, "positions")
            return
        port = port_formats.H5Trajectory(path)
        ref = ref_formats.H5Trajectory(path)
        for r in (port, ref):
            assert len(r) == 16
            with pytest.raises(OSError):
                r[:]
            r.close()
        assert port._h5py is None


def test_external_file_prefixes_come_first(tmp_path, monkeypatch):
    """HDF5's order: ``HDF5_EXT_PREFIX`` before the parent file's
    directory, which comes before the working directory; for external
    storage, ``HDF5_EXTFILE_PREFIX`` (``${ORIGIN}``: the file's directory)
    before the working directory.  Each pinned where both candidates exist
    and differ, beside h5py (libhdf5 reads ``HDF5_EXTFILE_PREFIX`` when it
    loads: that side runs in a process of its own)."""
    here, there, home = (tmp_path / d for d in ("here", "there", "home"))
    for k, d in enumerate((here, there, home)):
        d.mkdir()
        with h5py.File(d / "inner.h5", "w") as f:
            f["positions"] = layouts.frames(2, 4, seed=k).astype(np.float32)
        layouts.frames(2, 4, seed=k).astype(np.float32).tofile(d / "raw.bin")
    with h5py.File(here / "outer.h5", "w") as f:
        f["positions"] = h5py.ExternalLink("inner.h5", "/positions")
        f.create_dataset("stored", (2, 4, 3), np.float32,
                         external=[("raw.bin", 0, 96)])
    outer = str(here / "outer.h5")

    def same(key, seed):
        want = layouts.frames(2, 4, seed=seed).astype(np.float32)
        got = subprocess.run(
            [sys.executable, "-c", "import sys, h5py\n"
             f"with h5py.File({outer!r}, 'r') as f:\n"
             f"    sys.stdout.buffer.write(f[{key!r}][()].tobytes())"],
            capture_output=True, check=True).stdout
        assert got == want.tobytes()
        r = port_formats.H5Trajectory(outer, key)
        assert r._h5py is None and r[:].tobytes() == got
        r.close()
    monkeypatch.chdir(home)
    same("positions", 0)                    # the parent's directory
    monkeypatch.setenv("HDF5_EXT_PREFIX", f"{tmp_path}/none:{there}")
    same("positions", 1)                    # the prefix, first that opens
    same("stored", 2)                       # the working directory
    monkeypatch.setenv("HDF5_EXTFILE_PREFIX", str(there))
    same("stored", 1)
    monkeypatch.setenv("HDF5_EXTFILE_PREFIX", "${ORIGIN}")
    same("stored", 0)


def test_bench_headers_are_what_chip_smoke_reads():
    """The committed headers of ``tests/data/torch_h5_bench/`` are what
    ``bench_headers`` writes for ``chip_smoke.py``'s frames: a virtual
    dataset of the bench shape over four ring segments (five mappings),
    external storage over four raw segments, a link to ``md_1.h5`` (which
    is not there, so h5py and the port both raise ``KeyError``)."""
    bench = Path(layouts.BENCH)
    n, q = layouts.BENCH_SHAPE[0], layouts.BENCH_SHAPE[0] // 4
    vds = h5_store.H5Dataset(str(bench / "vds.h5"))
    assert vds.layout == "virtual" and vds.shape == layouts.BENCH_SHAPE
    assert [m.name for m in vds.mappings] == [
        "seg0.h5", "seg1.h5", "seg2.h5", "seg3.h5", "seg3.h5"]
    firsts = [int(m.virtual_sel[1][0, 0, 0]) for m in vds.mappings]
    assert firsts == [int(layouts.segment_frames(n, k)[0]) for k in range(4)
                      ] + [0]
    ext = h5_store.H5Dataset(str(bench / "external.h5"))
    frame = math.prod(layouts.BENCH_SHAPE[1:]) * 4
    assert ext.external == [(f"seg{k}.bin", 0, q * frame) for k in range(4)]
    with pytest.raises(KeyError):
        h5_store.H5Dataset(str(bench / "link.h5"))
    with h5py.File(bench / "link.h5", "r") as f, pytest.raises(KeyError):
        f["positions"]
    vds.close()
    ext.close()


def test_virtual_sources_open_once_under_threads():
    """A virtual dataset read from many threads at once, with the
    interpreter switching threads often: every read equals the fixture,
    each mapping opened its source once, and the files were opened once
    each."""
    import threading
    want = np.load(FIXTURES / "vds_strided.npy")
    ds = h5_store.H5Dataset(layouts.path_of("vds_strided"))
    opened = []
    real = h5_store._File.__init__

    def counting(self, path, files):
        opened.append(os.path.realpath(path))
        real(self, path, files)
    got = []
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        h5_store._File.__init__ = counting
        threads = [threading.Thread(target=lambda k=k: got.append(
            ds.read(k % 7, 9 + k % 7).tobytes() == want[k % 7:9 + k % 7]
            .tobytes())) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        h5_store._File.__init__ = real
        sys.setswitchinterval(was)
    assert got == [True] * 24
    assert sorted(opened) == sorted(set(opened)) and len(opened) == 5
    sources = {id(m.plan()[1]) for m in ds.mappings}
    assert len(sources) == len(ds.mappings)
    ds.close()


def test_extensible_array_pages_read_as_h5py(tmp_path):
    """Past 131,060 chunks along the unlimited axis an extensible array's
    data blocks are paged, each page marked in its super block's bitmap;
    written sparsely, most pages and super blocks are never made."""
    path = str(tmp_path / "long.h5")
    rng = np.random.default_rng(2)
    written = [(0, 10), (131050, 131200), (133000, 133003), (139990, 140000)]
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("positions", (140000, 1, 3), np.float32,
                             chunks=(1, 1, 3), maxshape=(None, 1, 3),
                             fillvalue=-3.0)
        for lo, hi in written:
            d[lo:hi] = rng.random((hi - lo, 1, 3))
    ds = h5_store.H5Dataset(path)
    assert ds.index == "extensible array"
    with h5py.File(path, "r") as f:
        d = f["positions"]
        for lo, hi in [(0, 12), (131000, 131300), (132990, 133010),
                       (139980, 140000), (50000, 50010)]:
            assert ds.read(lo, hi).tobytes() == d[lo:hi].tobytes(), lo
    assert ds.chunk_info() == h5_chunks(path, "positions")


def test_strided_one_frame_reads_decode_each_chunk_once(monkeypatch):
    path = str(FIXTURES / "earliest_shuffle_gzip.h5")
    ds = h5_store.H5Dataset(path)
    decoded = []
    real = ds._decode
    monkeypatch.setattr(ds, "_decode",
                        lambda idx, *a: decoded.append(idx) or real(idx, *a))
    want = np.load(FIXTURES / "earliest_shuffle_gzip.npy")
    for i in range(len(ds)):
        assert ds.take(slice(i, i + 1)).tobytes() == want[i:i + 1].tobytes()
    assert sorted(decoded) == sorted(set(decoded))
    assert len(decoded) == len(ds.chunk_info())


@pytest.mark.parametrize("name", [n for n in READ if "fletcher32" in n
                                  and "chunks" in layouts.LAYOUTS[n]])
def test_cached_chunks_survive_later_decodes(name):
    """Chunks kept for partly read ranges stay theirs while other chunks
    decode on the same threads: with Fletcher-32 checked last (first in
    the pipeline), the decoded bytes lie in a thread's scratch buffer, and
    a kept view of it would hand back a later chunk's bytes."""
    ds = h5_store.H5Dataset(str(FIXTURES / f"{name}.h5"))
    want = np.load(FIXTURES / f"{name}.npy")
    for i in range(len(ds)):
        assert ds.take(slice(i, i + 1)).tobytes() == want[i:i + 1].tobytes()
    for k in [slice(None, None, 3), slice(3, 9), -1, (slice(2, 9),
                                                     slice(5, 17))] * 2:
        assert ds.take(k).tobytes() == want[k].tobytes(), k
    assert len(ds._cache) == len(ds.chunk_info())


@pytest.mark.parametrize("chunked", [False, True, "segments"])
def test_chip_smoke_writer_reads_equal_through_h5py_and_the_port(
        tmp_path, chunked):
    """The files ``chip_smoke.py`` writes (the card's machine has no h5py):
    contiguous, chunked, and (``'segments'``) the ring segments and raw
    segments behind the headers of ``bench_headers``, read through the
    virtual dataset and external storage equal in h5py and the port."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    frames = layouts.incompressible(37, 50) + np.float32(0.5)
    if chunked == "segments":
        frames = layouts.incompressible(48, 50) + np.float32(0.5)
        layouts.bench_headers(str(tmp_path), frames.shape, turn=5)
        chip_smoke.write_h5_segments(str(tmp_path), frames, 5)
        with h5py.File(tmp_path / "seg1.h5", "r") as f:
            assert f["positions"].chunks == (8, 50, 3)
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.chdir(tmp_path)
        try:
            for name in ("vds.h5", "external.h5"):
                with h5py.File(tmp_path / name, "r") as f:
                    assert f["positions"][()].tobytes() == frames.tobytes()
                assert_reads_equal(tmp_path / name, "positions")
        finally:
            monkeypatch.undo()
        return
    path = str(tmp_path / "md.h5")
    chip_smoke.write_h5_trajectory(path, frames,
                                   chunk_frames=8 if chunked else None)
    with h5py.File(path, "r") as f:
        d = f["positions"]
        assert d.dtype == np.float32 and d.shape == frames.shape
        if chunked:
            assert d.chunks == (8, 50, 3) and d.compression == "gzip"
            assert d.compression_opts == 4 and d.shuffle
        else:
            assert d.chunks is None
        assert d[()].tobytes() == frames.tobytes()
    reader = port_formats.open_trajectory(path)
    assert type(reader) is port_formats.H5Trajectory and reader._h5py is None
    assert reader[:].tobytes() == frames.tobytes()
    if chunked:
        assert h5_store.H5Dataset(path).chunk_info() == h5_chunks(
            path, "positions")


WITHOUT_H5PY = textwrap.dedent("""
    import importlib.abc
    import sys
    import tempfile

    BLOCKED = ("h5py", "tensorstore", "jax", "jaxlib", "sitator_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from sitator_tpu_torch import SiteNetwork
    from sitator_tpu_torch.io import (H5Trajectory,
                                      make_fcc_hopping_trajectory,
                                      open_trajectory)
    from sitator_tpu_torch.io.h5_store import UnsupportedLayout
    from sitator_tpu_torch.io.tensorstore_io import TensorstoreTrajectory
    from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    n = 0
    for name, key, path, cwd in LAYOUTS:
        if name in REFUSED:
            try:
                H5Trajectory(path, key)
            except UnsupportedLayout as e:
                assert REFUSED[name] in str(e), str(e)
            else:
                raise AssertionError(f"{name} was not refused")
            continue
        want = np.load(os.path.join(FIXTURES, name + ".npy"))
        os.chdir(cwd or ROOT)
        r = (open_trajectory(path) if key == "positions"
             else H5Trajectory(path, key))
        assert type(r) is H5Trajectory and r._h5py is None, name
        assert r[:].tobytes() == want.tobytes(), name
        assert r[len(r) - 1].tobytes() == want[-1].tobytes(), name
        r.close()
        n += 1
    os.chdir(ROOT)
    for path in SNAPPY:
        want = np.load(path + ".npy")
        r = open_trajectory(path)
        assert type(r) is TensorstoreTrajectory and r._ts is None, path
        assert r[:].tobytes() == want.tobytes(), path

    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=6,
                                     n_frames=120, jump_rate=0.05, seed=3)
    tmp = tempfile.mkdtemp()
    seeds = VoronoiSiteGenerator().run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    kw = dict(cutoff_midpoint=3.1, cutoff_steepness=4.0, block_frames=48,
              verbose=False, device="cpu")
    want = StreamingLandmarkAnalysis(**kw)
    centers = want.fit_centers(seeds, md.traj.astype(np.float32))
    mem = want.run(seeds, md.traj.astype(np.float32), centers=centers)
    chip_smoke.write_h5_trajectory(os.path.join(HEADERS, "md_1.h5"),
                                   md.traj, chunk_frames=8)
    chip_smoke.write_h5_segments(HEADERS, md.traj, TURN)
    for chunk in (None, 8, "vds.h5", "external.h5", "link.h5"):
        path = os.path.join(tmp, f"md{chunk}.h5")
        if isinstance(chunk, str):
            path = os.path.join(HEADERS, chunk)
        else:
            chip_smoke.write_h5_trajectory(path, md.traj, chunk_frames=chunk)
        os.chdir(HEADERS if chunk == "external.h5" else ROOT)
        reader = open_trajectory(path)
        assert type(reader) is H5Trajectory and reader._h5py is None
        assert reader._ds.layout == {"vds.h5": "virtual", "external.h5":
                                     "external", "link.h5": "chunked"}.get(
            chunk, reader._ds.layout)
        sla = StreamingLandmarkAnalysis(**kw)
        got = sla.fit_centers(seeds, reader)
        assert np.array_equal(got, centers)
        out = sla.run(seeds, reader, centers=got)
        assert np.array_equal(out.n_ij, mem.n_ij) and out.n_ij.sum() > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print(f"H5-OK {n}")
""")


def test_every_fixture_and_a_streamed_run_without_h5py(tmp_path):
    """With ``h5py``, ``tensorstore``, ``jax`` and ``sitator_tpu``
    unimportable, as on the machine with the card: every fixture but the
    plugin filters and the compound type opens through ``open_trajectory``
    on the port's own reader, bit-equal to its ``.npy`` (external storage
    from its own directory); those three raise ``UnsupportedLayout``
    naming what they need; the Blosc-snappy zarr stores read on the port's
    codec; and the streaming fit and pass 2 from the five inputs of
    ``chip_smoke.py``'s ``h5_passes`` (contiguous; shuffle + deflate; a
    virtual dataset over ring segments, one chunked; external storage; an
    external link), their headers made here by ``bench_headers`` at this
    size, equal the run from memory."""
    from sitator_tpu_torch.io import make_fcc_hopping_trajectory
    from tests import _torch_zarr_layouts as zarr_layouts
    md = make_fcc_hopping_trajectory(n_cells=2, a=5.0, n_ions=6,
                                     n_frames=120, jump_rate=0.05, seed=3)
    layouts.bench_headers(str(tmp_path), (120, md.traj.shape[1], 3), turn=8)
    snappy = [os.path.join(zarr_layouts.FIXTURES, n)
              for n in sorted(zarr_layouts.LAYOUTS) if "snappy" in n]
    assert len(snappy) == 3
    where = [(n, layouts.key_of(n), layouts.path_of(n), layouts.cwd_of(n))
             for n in NAMES]
    script = (f"ROOT = {str(ROOT)!r}\nFIXTURES = {str(FIXTURES)!r}\n"
              f"LAYOUTS = {where!r}\n"
              f"REFUSED = {layouts.REFUSED!r}\nSNAPPY = {snappy!r}\n"
              f"HEADERS = {str(tmp_path)!r}\nTURN = 8\n" + WITHOUT_H5PY)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"H5-OK {len(READ)}" in proc.stdout
