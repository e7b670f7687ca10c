"""The port's NumPy copies against the JAX package's modules, on the CPU:
the synthetic-MD generators (bit-equal arrays from the same seed),
``suggest_cutoff``, ``elbow_index``, ``unwrap_trajectory``,
``NAvgsPerSite`` and ``RecenterTrajectory``.

Tolerances: everything here is the same NumPy code over the same inputs
in both packages, so every array is held exactly equal
(``assert_array_equal``), floats included.
"""
import dataclasses

import numpy as np
import pytest

import sitator_tpu.io as rio
from sitator_tpu.landmark import suggest_cutoff as ref_suggest
from sitator_tpu.misc import NAvgsPerSite as RefNAvgs
from sitator_tpu.misc import RecenterTrajectory as RefRecenter
from sitator_tpu.ops.msd import unwrap_trajectory as ref_unwrap
from sitator_tpu.util.elbow import elbow_index as ref_elbow
from sitator_tpu.voronoi import VoronoiSiteGenerator as RefVoronoi

import sitator_tpu_torch.io as pio
import sitator_tpu_torch.landmark as pland
import sitator_tpu_torch.misc as pmisc
from sitator_tpu_torch.core.structure import Structure as PortStructure
from sitator_tpu_torch.ops.msd import unwrap_trajectory as port_unwrap
from sitator_tpu_torch.util.elbow import elbow_index as port_elbow

from tests._torch_common import networks_of, trajectories

GENERATORS = [
    ("make_hopping_trajectory", dict(n_frames=60, seed=0)),
    ("make_hopping_trajectory", dict(n_frames=40, seed=7, n_cells=2,
                                     n_ions=3, jump_rate=0.1)),
    ("make_hopping_trajectory", dict(n_frames=30, seed=2, dtype=np.float64,
                                     frozen_disorder=0.0)),
    ("make_fcc_hopping_trajectory", dict(n_frames=50, seed=5, n_cells=2,
                                         a=5.0, n_ions=4)),
    ("make_fcc_hopping_trajectory", dict(n_frames=30, seed=11, n_cells=2,
                                         a=5.0, n_ions=6, jump_rate=0.05)),
    ("make_langevin_trajectory", dict(n_frames=20, seed=0, n_cells=2,
                                      n_ions=2)),
    ("make_langevin_trajectory", dict(n_frames=12, seed=3, n_cells=2,
                                      n_ions=3, steps_per_frame=4)),
]


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_generators_bit_equal_by_seed(name, kw):
    want = getattr(rio, name)(**kw)
    got = getattr(pio, name)(**kw)
    assert isinstance(got, pio.SyntheticMD)
    assert isinstance(got.structure, PortStructure)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "structure":
            np.testing.assert_array_equal(b.positions, a.positions)
            np.testing.assert_array_equal(b.species, a.species)
            np.testing.assert_array_equal(b.cell, a.cell)
        elif a is None:
            assert b is None
        else:
            assert b.dtype == a.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert got.n_frames == want.n_frames and got.n_ions == want.n_ions


def test_io_exports_the_generators():
    for name in ("SyntheticMD", "make_hopping_trajectory",
                 "make_fcc_hopping_trajectory", "make_langevin_trajectory"):
        assert name in pio.__all__ and name in rio.__all__
        assert hasattr(pio, name)


@pytest.fixture(scope="module")
def seeded():
    """A hopping run and its Voronoi seeds, the same in both packages."""
    md = rio.make_hopping_trajectory(n_frames=80, seed=3)
    seeds = RefVoronoi(verbose=False).run(networks_of(md)[0])
    sns = networks_of(md, centers=seeds.centers, vertices=seeds.vertices)
    return md, sns


@pytest.mark.parametrize("kw", [dict(), dict(n_sample_frames=5, seed=4),
                                dict(on_quantile=0.9, margin=0.2)],
                         ids=["default", "subsample", "quantile"])
def test_suggest_cutoff_equal(seeded, kw):
    md, (rsn, psn) = seeded
    assert "suggest_cutoff" in pland.__all__
    assert pland.suggest_cutoff(psn, md.traj, **kw) == \
        ref_suggest(rsn, md.traj, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elbow_index_equal(seed):
    rng = np.random.default_rng(seed)
    curve = np.sort(rng.uniform(0, 5, 9))[::-1] ** 2
    assert port_elbow(curve) == ref_elbow(curve)
    assert port_elbow(curve[:2]) == ref_elbow(curve[:2])


@pytest.mark.parametrize("cell", [
    np.eye(3) * 8.0,
    np.array([[8.0, 0, 0], [2.0, 7.5, 0], [1.0, -1.5, 9.0]])],
    ids=["cubic", "triclinic"])
@pytest.mark.parametrize("exact", [False, True])
def test_unwrap_trajectory_equal(cell, exact):
    rng = np.random.default_rng(5)
    walk = np.cumsum(rng.normal(scale=0.4, size=(50, 7, 3)), axis=0)
    frac = (rng.uniform(0, 1, (7, 3)) @ cell + walk) @ np.linalg.inv(cell)
    wrapped = (frac - np.floor(frac)) @ cell
    want = ref_unwrap(wrapped, cell, exact=exact)
    got = port_unwrap(wrapped, cell, exact=exact)
    np.testing.assert_array_equal(got, want)
    # and it did unwrap: increments stay small although the walk left the cell
    assert np.abs(np.diff(got, axis=0)).max() < 3.0


def _labelled(md, sns):
    """Ground-truth labels with a few unknowns and seeded confidences."""
    rng = np.random.default_rng(9)
    traj = md.true_assignments.astype(np.int32).copy()
    traj[rng.uniform(size=traj.shape) < 0.05] = -1
    conf = rng.uniform(0.2, 1.0, traj.shape)
    return trajectories(sns, traj, real_traj=md.traj, confidences=conf)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("n", [1, 3])
def test_navgs_per_site_equal(n, weighted):
    md = rio.make_hopping_trajectory(n_frames=120, seed=6, n_cells=2,
                                     n_ions=3, jump_rate=0.05)
    types = np.arange(len(md.true_sites)) % 2
    sns = networks_of(md, centers=md.true_sites, site_types=types)
    rst, pst = _labelled(md, sns)
    want = RefNAvgs(n=n, weighted=weighted, verbose=False).run(rst)
    got = pmisc.NAvgsPerSite(n=n, weighted=weighted, verbose=False).run(pst)
    assert got.n_sites == want.n_sites > 0
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.source_site, want.source_site)
    np.testing.assert_array_equal(got.site_types, want.site_types)


def test_navgs_insufficient_raises_in_both():
    md = rio.make_hopping_trajectory(n_frames=20, seed=6, n_cells=2,
                                     n_ions=2)
    rst, pst = _labelled(md, networks_of(md, centers=md.true_sites))
    for cls, st in ((RefNAvgs, rst), (pmisc.NAvgsPerSite, pst)):
        with pytest.raises(ValueError, match="points"):
            cls(n=50, error_on_insufficient=True, verbose=False).run(st)


@pytest.mark.parametrize("case", ["unwrapped", "wrapped", "masses",
                                  "in_place"])
def test_recenter_trajectory_equal(case):
    rng = np.random.default_rng(1)
    L, F, N = 10.0, 30, 6
    cell = np.eye(3) * L
    base = rng.uniform(1, 9, size=(N, 3))
    base[0] = [0.02, 5.0, 5.0]                     # sits on the x face
    drift = np.cumsum(rng.normal(scale=0.05, size=(F, 1, 3)), axis=0)
    traj = base[None] + drift + rng.normal(scale=0.05, size=(F, N, 3))
    static = np.array([True] * 4 + [False] * 2)
    kw, init = {}, {}
    if case == "wrapped":
        traj, kw = traj % L, dict(cell=cell)
    elif case == "masses":
        init = dict(masses=rng.uniform(1, 30, int(static.sum())))
    elif case == "in_place":
        kw = dict(in_place=True)
    a, b = traj.copy(), traj.copy()
    want = RefRecenter(**init).run(static, a, **kw)
    got = pmisc.RecenterTrajectory(**init).run(static, b, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b, a)            # same in-place effect
    assert (got is b) == (case == "in_place")
