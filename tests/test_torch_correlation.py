"""The port's pair-correlation histograms (``ops/correlation.py``) and
engines (``RDFAnalysis``, ``VanHoveAnalysis``) against the JAX package's,
on the CPU.

Tolerances:

- Pair histograms are held by the edge rule: the two packages' counts may
  differ only by pairs whose float64 distance lies within 4 float32 ulps
  of a bin edge, the ulps taken at the scale of the coordinates (the
  cell's longest row) — the fractional round trip carries the
  coordinates' absolute rounding into every distance, and a distance
  that close to an edge can fall into the neighbouring bin under another
  float32 evaluation order.  The sum of |differences| may not exceed
  twice that number of pairs.
- Within the port the counts are integers that must not depend on how
  the frames are cut into chunks: held exactly equal; and they equal a
  NumPy float32 replica of the port's steps bit for bit.
- ``van_hove_self`` and the normalisations are host float64: 1e-12.
"""
import numpy as np
import pytest
import torch

from sitator_tpu.dynamics import RDFAnalysis as RefRDF
from sitator_tpu.dynamics import VanHoveAnalysis as RefVanHove
from sitator_tpu.ops import correlation as ref_corr
from sitator_tpu_torch.dynamics import RDFAnalysis, VanHoveAnalysis
from sitator_tpu_torch.ops import correlation as corr

from tests._torch_common import (first_math_calls_on_one_thread, networks,
                                 trajectories)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

RTOL = 1e-12
CUBIC = np.eye(3) * 9.0
TRICLINIC = np.array([[9.0, 0, 0], [1.2, 8.5, 0], [0.6, -0.9, 9.5]])


def near_edge_pairs(fa, fb, exclude, cell, r_max, n_bins, ulps=4):
    """Pairs (not excluded) whose float64 minimum-image distance, from the
    float32-rounded inputs, lies within ``ulps`` float32 ulps of a bin
    edge (the last edge, ``r_max``, included)."""
    fa = np.asarray(fa, np.float32).astype(np.float64)
    fb = np.asarray(fb, np.float32).astype(np.float64)
    inv = np.linalg.inv(cell)
    df = (fa[:, :, None, :] - fb[:, None, :, :]) @ inv
    df -= np.round(df)
    d = np.sqrt(((df @ cell) ** 2).sum(-1))
    shifts = np.array(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"))
    shifts = shifts.reshape(3, -1).T @ cell
    # the exact 27-image distance, for the exact route's comparison
    d27 = np.sqrt((((df @ cell)[..., None, :] + shifts) ** 2).sum(-1)).min(-1)
    tol = ulps * np.spacing(np.float32(np.linalg.norm(cell, axis=1).max()))
    width = r_max / n_bins
    out = []
    for dist in (d, d27):
        x = dist / width
        near = np.abs(x - np.round(x)) * width <= tol
        out.append(int((near & ~np.asarray(exclude)[None]).sum()))
    return out


def check_edge_rule(got, want, n_near):
    diff = int(np.abs(np.asarray(got) - np.asarray(want)).sum())
    assert diff <= 2 * n_near, (diff, n_near)


def _frames(seed, F, N, cell):
    rng = np.random.default_rng(seed)
    return rng.random((F, N, 3)) @ cell


@pytest.mark.parametrize("cell", [CUBIC, TRICLINIC],
                         ids=["cubic", "triclinic"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("sel", ["same", "overlap", "disjoint"])
def test_pair_hist_by_the_edge_rule(cell, exact, sel):
    traj = _frames(0, 5, 40, cell)
    ma = np.arange(40) < 20
    mb = {"same": ma, "overlap": np.arange(40) >= 10,
          "disjoint": ~ma}[sel]
    ex = corr._exclude_matrix(ma, mb)
    np.testing.assert_array_equal(ex, ref_corr._exclude_matrix(ma, mb))
    r_max = corr._resolve_r_max(None, cell, exact)
    got = corr._pair_hist(traj[:, ma], traj[:, mb], ex, cell, r_max, 60,
                          exact, device="cpu")
    want = np.asarray(ref_corr._pair_hist(traj[:, ma], traj[:, mb], ex,
                                          cell, r_max, 60, exact))
    assert got.dtype == np.int64 and got.shape == (60,)
    assert got.sum() > 0
    near = near_edge_pairs(traj[:, ma], traj[:, mb], ex, cell, r_max, 60)
    check_edge_rule(got, want, near[int(exact)])


def numpy_f32_bins(fa, fb, cell, r_max, n_bins):
    """Each pair's bin by the port's steps in NumPy float32 (every ufunc
    one correctly rounded operation, ``np.sqrt`` included)."""
    f32 = np.float32
    fa, fb, c = (np.asarray(x, f32) for x in (fa, fb, cell))
    ci = torch.linalg.inv(torch.from_numpy(c)).numpy()
    dx = [fa[:, :, None, k] - fb[:, None, :, k] for k in range(3)]
    df = [dx[0] * ci[0, j] + dx[1] * ci[1, j] + dx[2] * ci[2, j]
          for j in range(3)]
    df = [f - np.round(f) for f in df]
    d = [df[0] * c[0, k] + df[1] * c[1, k] + df[2] * c[2, k]
         for k in range(3)]
    dist = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return np.floor(dist * f32(n_bins / r_max)).astype(np.int64)


@pytest.mark.parametrize("n_bins", [80, 2 ** 23])
@pytest.mark.parametrize("cell", [CUBIC, TRICLINIC],
                         ids=["cubic", "triclinic"])
def test_counts_equal_a_numpy_float32_replica(cell, n_bins):
    """Bit for bit: the same IEEE steps in NumPy give the same bins (so a
    CUDA tensor, whose steps are the same IEEE operations, gives them
    too).  With 2^23 bins over 4 Å a bin is about one float32 ulp of the
    distance wide, so a root off by an ulp (torch's own float32 ``sqrt``
    on the CPU) moves pairs."""
    traj = _frames(5, 6, 60, cell)
    r_max = corr._resolve_r_max(None, cell, False) if n_bins == 80 else 4.0
    ex = np.eye(60, dtype=bool)
    idx = numpy_f32_bins(traj, traj, cell, r_max, n_bins)
    idx = np.where(ex[None] | (idx >= n_bins), n_bins, idx)
    want = np.bincount(idx.ravel(), minlength=n_bins + 1)[:n_bins]
    got = corr._pair_hist(traj, traj, ex, cell, r_max, n_bins, False,
                          device="cpu")
    assert want.sum() > 1000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("cell", [CUBIC, TRICLINIC],
                         ids=["cubic", "triclinic"])
def test_counts_do_not_depend_on_the_chunking(exact, cell, monkeypatch):
    """1 frame, 3 frames and all 7 frames a chunk give the same counts."""
    F, na, nb = 7, 12, 30
    traj = _frames(1, F, nb, cell)
    ex = corr._exclude_matrix(np.arange(nb) < na, np.ones(nb, bool))
    r_max = 0.9 * corr._resolve_r_max(None, cell, exact)
    per_frame = corr._PAIR_BYTES * na * nb
    runs = []
    for frames in (1, 3, F):
        monkeypatch.setattr(corr, "_CHUNK_BYTES", frames * per_frame)
        assert corr._chunk_frames(F, na, nb) == frames
        runs.append(corr._pair_hist(traj[:, :na], traj, ex, cell, r_max, 40,
                                    exact, device="cpu"))
    for other in runs[1:]:
        np.testing.assert_array_equal(other, runs[0])
    assert runs[0].sum() > 0


def test_exact_route_finds_the_nearer_image_of_a_skewed_cell():
    """In a strongly skewed cell the rounded image is not always the
    nearest one; the 27-image route is never farther."""
    cell = np.array([[6.0, 0, 0], [5.0, 2.0, 0], [0, 0, 6.0]])
    traj = _frames(2, 3, 25, cell)
    r_max = corr._min_cell_height(cell)
    ex = np.eye(25, dtype=bool)
    plain = corr._pair_hist(traj, traj, ex, cell, 2 * r_max, 50, False,
                            device="cpu")
    exact = corr._pair_hist(traj, traj, ex, cell, 2 * r_max, 50, True,
                            device="cpu")
    assert exact.sum() >= plain.sum()
    assert (np.cumsum(exact) >= np.cumsum(plain)).all()
    assert not np.array_equal(exact, plain)


@pytest.mark.parametrize("exact", [False, True])
def test_rdf_matches_reference(exact):
    cell = TRICLINIC
    traj = _frames(3, 6, 30, cell)
    ma, mb = np.arange(30) < 18, np.arange(30) >= 8
    r_max = corr._resolve_r_max(None, cell, exact)
    r, g = corr.rdf(traj, cell, ma, mb, n_bins=50, exact=exact,
                    device="cpu")
    r_ref, g_ref = ref_corr.rdf(traj, cell, ma, mb, n_bins=50, exact=exact)
    np.testing.assert_array_equal(r, r_ref)
    ex = corr._exclude_matrix(ma, mb)
    counts = corr._pair_hist(traj[:, ma], traj[:, mb], ex, cell, r_max, 50,
                             exact, device="cpu")
    want = np.asarray(ref_corr._pair_hist(traj[:, ma], traj[:, mb], ex,
                                          cell, r_max, 50, exact))
    check_edge_rule(counts, want, near_edge_pairs(
        traj[:, ma], traj[:, mb], ex, cell, r_max, 50)[int(exact)])
    same = counts == want
    np.testing.assert_allclose(g[same], np.asarray(g_ref)[same], rtol=RTOL)


def test_van_hove_matches_reference():
    cell = CUBIC
    rng = np.random.default_rng(4)
    F, n = 30, 10
    traj = np.cumsum(rng.normal(scale=0.4, size=(F, n, 3)), 0) + 4.5
    mask = np.ones(n, bool)
    lags = [0, 1, 5, 20]
    r, G = corr.van_hove_distinct(traj, cell, mask, lags, n_bins=30,
                                  origin_stride=2, device="cpu")
    r_ref, G_ref = ref_corr.van_hove_distinct(traj, cell, mask, lags,
                                              n_bins=30, origin_stride=2)
    np.testing.assert_array_equal(r, r_ref)
    origins = np.arange(0, F - max(lags), 2)
    r_max = corr._resolve_r_max(None, cell, False)
    for k, lag in enumerate(lags):
        near = near_edge_pairs(traj[origins], traj[origins + lag],
                               np.eye(n, dtype=bool), cell, r_max, 30)[0]
        norm = len(origins) * n * (n - 1) * corr._shell_volumes(
            r_max, 30)[0] / abs(np.linalg.det(cell))
        check_edge_rule(np.round(G[k] * norm), np.round(G_ref[k] * norm),
                        near)
        if near == 0:
            np.testing.assert_allclose(G[k], G_ref[k], rtol=RTOL)
    for stride in (1, 3):
        assert_self = (corr.van_hove_self(traj, cell, mask, lags, n_bins=30,
                                          origin_stride=stride),
                       ref_corr.van_hove_self(traj, cell, mask, lags,
                                              n_bins=30,
                                              origin_stride=stride))
        for a, b in zip(*assert_self):
            np.testing.assert_allclose(a, b, rtol=RTOL)


def test_engines_match_reference():
    from sitator_tpu.io import make_hopping_trajectory
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=80,
                                 jump_rate=0.05, seed=31)
    s = md.structure
    sns = networks(s.positions, s.species, s.cell, md.static_mask,
                   md.mobile_mask)
    st_ref, st = trajectories(sns, np.zeros((80, 6), np.int32), md.traj)
    mob, sta = md.mobile_mask, md.static_mask
    r_max = corr._resolve_r_max(None, s.cell, False)
    vol = abs(np.linalg.det(s.cell))
    for kw, ma, mb in ((dict(select_a="mobile", select_b="static"), mob,
                        sta), (dict(select_a=3, n_bins=40), mob, mob)):
        got = RDFAnalysis(verbose=False, device="cpu", **kw).run(st)
        want = RefRDF(verbose=False, **kw).run(st_ref)
        np.testing.assert_array_equal(got.r_, want.r_)
        n_bins = kw.get("n_bins", 200)
        ex = corr._exclude_matrix(ma, mb)
        norm = 80 * (ma.sum() * mb.sum() - ex.sum()) * corr._shell_volumes(
            r_max, n_bins)[0] / vol
        counts = [np.rint(e.g_ * norm) for e in (got, want)]
        check_edge_rule(*counts, near_edge_pairs(
            md.traj[:, ma], md.traj[:, mb], ex, s.cell, r_max, n_bins)[0])
        same = counts[0] == counts[1]
        np.testing.assert_allclose(got.g_[same], want.g_[same], rtol=RTOL)
    got = VanHoveAnalysis(lags=(0, 20), n_bins=50, origin_stride=20,
                          verbose=False, device="cpu").run(st)
    want = RefVanHove(lags=(0, 20), n_bins=50, origin_stride=20,
                      verbose=False).run(st_ref)
    np.testing.assert_allclose(got.G_self_, want.G_self_, rtol=RTOL)
    np.testing.assert_array_equal(got.r_, want.r_)
    origins = np.arange(0, 60, 20)
    norm = len(origins) * 6 * 5 * corr._shell_volumes(r_max, 50)[0] / vol
    for k, lag in enumerate((0, 20)):
        check_edge_rule(np.rint(got.G_distinct_[k] * norm),
                        np.rint(want.G_distinct_[k] * norm),
                        near_edge_pairs(md.traj[origins][:, mob],
                                        md.traj[origins + lag][:, mob],
                                        np.eye(6, dtype=bool), s.cell, r_max,
                                        50)[0])
    for pkg_engine, pst in ((RDFAnalysis, st), (RefRDF, st_ref)):
        kw = {"device": "cpu"} if pkg_engine is RDFAnalysis else {}
        with pytest.raises(ValueError, match="unknown selection"):
            pkg_engine(select_a="bogus", verbose=False, **kw).run(pst)


def test_validation_matches_reference():
    cell = np.eye(3) * 8.0
    traj = np.zeros((2, 3, 3))
    mask = np.ones(3, bool)
    for pkg, kw in ((corr, {"device": "cpu"}), (ref_corr, {})):
        with pytest.raises(ValueError, match="minimum-image validity"):
            pkg.rdf(traj, cell, mask, r_max=4.5, **kw)
        pkg.rdf(traj, cell, mask, r_max=4.5, exact=True, **kw)
        with pytest.raises(ValueError, match="minimum-image validity"):
            pkg.rdf(traj, cell, mask, r_max=8.5, exact=True, **kw)
        with pytest.raises(ValueError, match="outside"):
            pkg.van_hove_distinct(traj, cell, mask, lags=[2], **kw)
        with pytest.raises(ValueError, match="outside"):
            pkg.van_hove_self(traj, cell, mask, lags=[2])
    assert corr._min_cell_height(TRICLINIC) == \
        ref_corr._min_cell_height(TRICLINIC)
    for r_max in (None, 3.0):
        assert corr._resolve_r_max(r_max, TRICLINIC, False) == \
            ref_corr._resolve_r_max(r_max, TRICLINIC, False)


def test_bin_counts_stay_exact_past_float32(monkeypatch):
    """One bin past 2^24 counts: int64 counts stay exact (in chunks of
    64 MB of temporaries, so the test stays small)."""
    monkeypatch.setattr(corr, "_CHUNK_BYTES", 2 ** 26)
    n, F = 650, 40
    pts = np.random.default_rng(0).normal(scale=1e-3, size=(F, n, 3)) + 5.0
    r, g = corr.rdf(pts, np.eye(3) * 10.0, np.ones(n, bool), r_max=1.0,
                    n_bins=4, device="cpu")
    shells = 4 / 3 * np.pi * np.diff(np.linspace(0, 1.0, 5) ** 3)
    counts = g * (F * n * (n - 1) * shells / 1000.0)
    assert int(round(counts.sum())) == F * n * (n - 1) > 2 ** 24
