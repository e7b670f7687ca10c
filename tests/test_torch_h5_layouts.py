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
integers and floats, partial edge chunks stored unfiltered; float64, big-endian,
float16 and integer data; an H5MD path, soft links, dense groups, creation
order, a user block, continuation blocks and SWMR.  Each is written anew by
the h5py installed here and held bit for bit to the reference over whole,
cut, strided and single-frame reads; the committed fixtures (what
``chip_smoke.py`` reads on the card) are held to h5py and the port, and
their chunk lists to h5py's ``get_chunk_info``; chunks kept for partly
read ranges stay right while later chunks decode.  Also: errors keep h5py's
types, szip, n-bit and every other left-out feature are refused by name (and
the native filters without the native codec), a paged extensible array
reads as h5py reads it, with ``h5py`` unimportable the
port reads every other fixture and streams from an HDF5 file, and
``chip_smoke.py``'s own writer makes files both readers read equal.  Every
comparison is exact.
"""
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
NAMES = sorted(layouts.LAYOUTS)
READ = [n for n in NAMES if n not in layouts.REFUSED]
CHUNKED = [n for n in READ if "chunks" in layouts.LAYOUTS[n]]


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


def assert_reads_equal(path, key):
    port = port_formats.H5Trajectory(str(path), key)
    ref = ref_formats.H5Trajectory(str(path), key)
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
    path = tmp_path / f"{name}.h5"
    want = layouts.write(str(path), name)
    assert_reads_equal(path, layouts.key_of(name))
    got = h5_store.H5Dataset(str(path), layouts.key_of(name))
    assert got.read(0, len(want)).tobytes() == want.tobytes()


@pytest.mark.parametrize("name", READ)
def test_fixture_equals_h5py_and_the_port(name):
    path = FIXTURES / f"{name}.h5"
    want = np.load(FIXTURES / f"{name}.npy")
    with h5py.File(path, "r") as f:
        assert np.asarray(f[layouts.key_of(name)][()],
                          np.float32).tobytes() == want.tobytes()
    assert_reads_equal(path, layouts.key_of(name))


@pytest.mark.parametrize("name", CHUNKED)
def test_chunk_list_equals_h5py(name):
    path = FIXTURES / f"{name}.h5"
    key = layouts.key_of(name)
    got = h5_store.H5Dataset(str(path), key).chunk_info()
    assert got == h5_chunks(path, key) and got


def test_fixtures_are_every_layout_and_small():
    assert sorted(p.stem for p in FIXTURES.glob("*.h5")) == NAMES
    assert sorted(p.stem for p in FIXTURES.glob("*.npy")) == NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 3_000_000
    # what the fixtures are there to reach
    formats = {}
    for name in READ:
        with h5py.File(FIXTURES / f"{name}.h5", "r") as f:
            formats[f.id.get_create_plist().get_version()[0]] = name
    assert sorted(formats) == [0, 2, 3]
    indices = {h5_store.H5Dataset(str(FIXTURES / f"{n}.h5"),
                                  layouts.key_of(n)).index for n in CHUNKED}
    assert indices == {"v1 B-tree", "single chunk", "implicit",
                       "fixed array", "extensible array", "v2 B-tree"}
    # LZF stores incompressible chunks raw, under filter mask 1
    for name in ("earliest_lzf_incompressible", "latest_lzf_incompressible"):
        masks = {m for *_, m in h5_store.H5Dataset(
            str(FIXTURES / f"{name}.h5")).chunk_info()}
        assert masks == {1}


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


@pytest.mark.parametrize("name,filt", sorted(layouts.REFUSED.items()))
def test_refused_filters_are_named(name, filt, monkeypatch):
    path = str(FIXTURES / f"{name}.h5")
    with pytest.raises(h5_store.UnsupportedLayout, match=filt):
        h5_store.H5Dataset(path)
    # with h5py, the last resort reads it as the reference does
    r = port_formats.H5Trajectory(path)
    assert r._h5py is not None
    np.testing.assert_array_equal(r[:], np.load(FIXTURES / f"{name}.npy"))
    r.close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(h5_store.UnsupportedLayout,
                       match=f"{filt}.*h5py, which would read it"):
        port_formats.H5Trajectory(path)


def test_filters_needing_the_native_codec_refused_without_it(monkeypatch):
    """Without g++ the native codec is not built: shuffle, LZF,
    Fletcher-32 and scale-offset are refused by name when the dataset is
    opened, and deflate alone (Python's zlib) still reads."""
    monkeypatch.setattr(h5_store, "_codec", lambda: None)
    for name, filt in (("earliest_shuffle_gzip", "shuffle"),
                       ("earliest_lzf", "lzf"),
                       ("earliest_fletcher32", "fletcher32"),
                       ("earliest_scaleoffset_int", "scale-offset")):
        with pytest.raises(h5_store.UnsupportedLayout,
                           match=f"{filt} needs the native codec"):
            h5_store.H5Dataset(str(FIXTURES / f"{name}.h5"))
    got = h5_store.H5Dataset(str(FIXTURES / "earliest_gzip9.h5")).read(0, 16)
    assert got.tobytes() == np.load(FIXTURES / "earliest_gzip9.npy").tobytes()


def _external_link(tmp_path):
    path = tmp_path / "outer.h5"
    with h5py.File(tmp_path / "inner.h5", "w") as f:
        f["positions"] = np.zeros((2, 4, 3), np.float32)
    with h5py.File(path, "w") as f:
        f["positions"] = h5py.ExternalLink("inner.h5", "/positions")
    return path


def _virtual(tmp_path):
    path = tmp_path / "virtual.h5"
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f["x"] = np.zeros((2, 4, 3), np.float32)
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
    return path


def _plugin_filter(tmp_path):
    path = tmp_path / "plugin.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("positions", (4, 4, 3), np.float32, chunks=True,
                         compression=32015, allow_unknown_filter=True)
    return path


def _compound(tmp_path):
    path = tmp_path / "compound.h5"
    with h5py.File(path, "w") as f:
        f["positions"] = np.zeros((2, 4), [("x", "<f4"), ("y", "<i4")])
    return path


@pytest.mark.parametrize("make,named", [
    (_external_link, "external link"), (_virtual, "virtual dataset"),
    (_external_storage, "external storage"), (_plugin_filter, "zstd"),
    (_compound, "compound")])
def test_features_left_out_are_refused_by_name(tmp_path, make, named):
    with pytest.raises(h5_store.UnsupportedLayout, match=named):
        h5_store.H5Dataset(str(make(tmp_path)))


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


@pytest.mark.parametrize("chunked", [False, True])
def test_chip_smoke_writer_reads_equal_through_h5py_and_the_port(
        tmp_path, chunked):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    frames = layouts.incompressible(37, 50) + np.float32(0.5)
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

    BLOCKED = ("h5py", "jax", "jaxlib", "sitator_tpu")

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
    from sitator_tpu_torch.landmark import StreamingLandmarkAnalysis
    from sitator_tpu_torch.voronoi import VoronoiSiteGenerator

    n = 0
    for name, key in LAYOUTS:
        want = np.load(os.path.join(FIXTURES, name + ".npy"))
        path = os.path.join(FIXTURES, name + ".h5")
        if name in REFUSED:
            try:
                H5Trajectory(path, key)
            except UnsupportedLayout as e:
                assert REFUSED[name] in str(e), str(e)
            else:
                raise AssertionError(f"{name} was not refused")
            continue
        r = (open_trajectory(path) if key == "positions"
             else H5Trajectory(path, key))
        assert type(r) is H5Trajectory and r._h5py is None, name
        assert r[:].tobytes() == want.tobytes(), name
        assert r[len(r) - 1].tobytes() == want[-1].tobytes(), name
        r.close()
        n += 1

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
    for chunk in (None, 8):
        path = os.path.join(tmp, f"md{chunk}.h5")
        chip_smoke.write_h5_trajectory(path, md.traj, chunk_frames=chunk)
        reader = open_trajectory(path)
        assert type(reader) is H5Trajectory and reader._h5py is None
        sla = StreamingLandmarkAnalysis(**kw)
        got = sla.fit_centers(seeds, reader)
        assert np.array_equal(got, centers)
        out = sla.run(seeds, reader, centers=got)
        assert np.array_equal(out.n_ij, mem.n_ij) and out.n_ij.sum() > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print(f"H5-OK {n}")
""")


def test_every_fixture_and_a_streamed_run_without_h5py():
    """With ``h5py`` (and ``jax`` and ``sitator_tpu``) unimportable, as on
    the machine with the card: every fixture but szip and n-bit opens
    through ``open_trajectory`` on the port's own reader, bit-equal to its
    ``.npy``; szip and n-bit raise ``UnsupportedLayout`` naming the
    filter; and the streaming fit and pass 2 from the two files of
    ``chip_smoke.py``'s ``h5_passes`` (contiguous; shuffle + deflate)
    equal the run from memory."""
    script = (f"ROOT = {str(ROOT)!r}\nFIXTURES = {str(FIXTURES)!r}\n"
              f"LAYOUTS = {[(n, layouts.key_of(n)) for n in NAMES]!r}\n"
              f"REFUSED = {layouts.REFUSED!r}\n" + WITHOUT_H5PY)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"H5-OK {len(READ)}" in proc.stdout
