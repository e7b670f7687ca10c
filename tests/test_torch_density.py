"""Density grids and the density site generator in the port against the
JAX package, on the CPU.

Tolerances: the ``(n, n, n)`` int64 count grid is held **equal** (both
packages bin float32 fractional coordinates; a count could differ only for
an atom within a few float32 ulp of a bin seam, and none of these inputs
has one); smoothing and peak finding are the same float64 NumPy/SciPy code
on equal grids, so centres, weights and vertex sets are equal too.
"""
import numpy as np
import pytest
import torch

from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.network import DensitySiteGenerator as RefGenerator
from sitator_tpu.ops import density as rden

from sitator_tpu_torch.io import ArrayTrajectory
from sitator_tpu_torch.landmark import LandmarkAnalysis
from sitator_tpu_torch.network import (DensitySiteGenerator, match_sites)
from sitator_tpu_torch.ops import density as pden

from tests._torch_common import (first_math_calls_on_one_thread,
                                 networks_of)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

TRICLINIC = np.array([[9.0, 0, 0], [2.0, 8.5, 0], [1.0, -1.5, 9.5]])


@pytest.fixture(scope="module")
def md():
    return make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6, n_frames=400,
                                   jump_rate=0.05, seed=3)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mask=True),
    dict(mask=True, stride=3, chunk=50),       # chunk cut to a stride multiple
    dict(chunk=37, n_bins=20),                 # a chunk that does not divide F
    dict(mask=True, stride=7, chunk=3),        # stride larger than the chunk
    dict(n_bins=2),
], ids=["all", "mask", "stride", "ragged-chunk", "wide-stride", "two-bins"])
def test_density_grid_equal(md, kw):
    kw = dict(kw)
    if kw.pop("mask", False):
        kw["mask"] = md.mobile_mask
    want = rden.density_grid(md.traj, md.structure.cell, **kw)
    got = pden.density_grid(ArrayTrajectory(md.traj), md.structure.cell,
                            device="cpu", **kw)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    n_atoms = int(kw["mask"].sum()) if "mask" in kw else md.traj.shape[1]
    n_frames = len(range(0, md.n_frames, kw.get("stride", 1)))
    assert got.sum() == n_frames * n_atoms


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_density_grid_triclinic_unwrapped_equal(dtype):
    """Coordinates up to two cells outside a skewed cell, as an in-memory
    array of either precision."""
    rng = np.random.default_rng(0)
    traj = (rng.uniform(-1, 2, (40, 30, 3)) @ TRICLINIC).astype(dtype)
    want = rden.density_grid(traj, TRICLINIC, n_bins=16, chunk=16)
    got = pden.density_grid(traj, TRICLINIC, n_bins=16, chunk=16,
                            device="cpu")
    np.testing.assert_array_equal(got, want)


def test_density_grid_matches_float64_histogram_off_seams(md):
    """Against an independent float64 histogram.  The float32 binning can
    differ from it only for an atom within a few float32 ulp of a seam
    (an ulp of ``frac · n`` is 2e-6 of a bin here); the nearest atom of
    this run is over 1e-5 of a bin away, so the grids are equal."""
    n = 24
    cell = md.structure.cell
    pos = md.traj[:, md.mobile_mask].reshape(-1, 3).astype(np.float64)
    x = pos @ np.linalg.inv(cell)
    x = (x - np.floor(x)) * n
    assert np.abs(x - np.round(x)).min() > 1e-5       # no atom on a seam
    idx = np.minimum(x.astype(np.int64), n - 1)
    want = np.zeros((n, n, n), np.int64)
    np.add.at(want, tuple(idx.T), 1)
    got = pden.density_grid(md.traj, cell, mask=md.mobile_mask, n_bins=n,
                            device="cpu")
    np.testing.assert_array_equal(got, want)


def test_density_grid_validation(md):
    cell = md.structure.cell
    with pytest.raises(ValueError, match="no atoms"):
        pden.density_grid(md.traj, cell, device="cpu",
                          mask=np.zeros(md.traj.shape[1], bool))
    with pytest.raises(ValueError, match="n_bins"):
        pden.density_grid(md.traj, cell, n_bins=1, device="cpu")
    with pytest.raises(ValueError, match="stride"):
        pden.density_grid(md.traj, cell, stride=0, device="cpu")


@pytest.mark.parametrize("cell", [np.eye(3) * 12.0, TRICLINIC],
                         ids=["cubic", "triclinic"])
def test_smoothing_and_peaks_equal(cell):
    rng = np.random.default_rng(4)
    grid = rng.poisson(0.3, (20, 20, 20)).astype(np.int64)
    for c in ([3, 4, 5], [15, 15, 2], [0, 19, 10]):    # one blob on the seam
        grid[tuple(c)] += 400
    want_s = rden.smooth_density(grid, cell, 0.6)
    got_s = pden.smooth_density(grid, cell, 0.6)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(pden._cell_heights(cell),
                                  rden._cell_heights(cell))
    for kw in (dict(), dict(threshold_rel=0.5, min_distance=3.0)):
        wc, ww = rden.find_density_peaks(want_s, cell, **kw)
        gc, gw = pden.find_density_peaks(got_s, cell, **kw)
        assert len(gc) == len(wc) >= 3
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gw, ww)
    empty = pden.find_density_peaks(np.zeros((6, 6, 6)), cell)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)


@pytest.mark.parametrize("kw", [
    dict(n_bins=36, sigma=0.5, threshold=0.02, min_distance=1.5),
    dict(n_bins=24, sigma=0.7, threshold=0.05, min_distance=2.0,
         n_vertices=5, stride=2, chunk=64),
], ids=["fine", "coarse-strided"])
def test_density_site_generator_equal(md, kw):
    rsn0, psn0 = networks_of(md)
    want = RefGenerator(verbose=False, **kw).run(rsn0, md.traj)
    got = DensitySiteGenerator(verbose=False, device="cpu", **kw).run(
        psn0, ArrayTrajectory(md.traj))
    assert got.n_sites == want.n_sites > 0
    np.testing.assert_allclose(got.centers, want.centers, atol=1e-12)
    np.testing.assert_array_equal(got.site_density, want.site_density)
    for a, b in zip(got.vertices, want.vertices):
        np.testing.assert_array_equal(a, b)
    # the centres sit on the true sites the ions visited
    truth = networks_of(md, centers=md.true_sites[
        np.unique(md.true_assignments)])[1]
    mapping, dists = match_sites(got, truth)
    assert (mapping >= 0).all() and np.nanmax(dists) < 0.6


def test_density_sites_feed_landmark_analysis(md):
    """Seed (density) → landmark analysis, all in the port."""
    sn = DensitySiteGenerator(n_bins=36, sigma=0.5, threshold=0.02,
                              min_distance=1.5, verbose=False,
                              device="cpu").run(networks_of(md)[1], md.traj)
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False, device="cpu").run(sn, md.traj)
    assert st.percent_unassigned < 0.05


def test_density_site_generator_validation(md, monkeypatch):
    with pytest.raises(ValueError, match="threshold"):
        DensitySiteGenerator(threshold=1.0)
    with pytest.raises(ValueError, match="n_vertices"):
        DensitySiteGenerator(n_vertices=0)
    # a peakless field raises the instructive error
    monkeypatch.setattr(pden, "find_density_peaks",
                        lambda *a, **k: (np.zeros((0, 3)), np.zeros(0)))
    with pytest.raises(ValueError, match="no density peaks"):
        DensitySiteGenerator(verbose=False, device="cpu").run(
            networks_of(md)[1], md.traj)
