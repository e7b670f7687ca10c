"""The port's kinetics engines against the JAX package's, on the CPU:
``MergeSitesByMetastability`` / ``pcca_memberships``,
``MarkovianityAnalysis``, ``ChainUncertaintyAnalysis`` /
``edge_probability_intervals``, ``TransitionPathAnalysis``,
``ResidenceTimeAnalysis``, ``ArrheniusAnalysis`` /
``EdgeArrheniusAnalysis``, ``SiteFreeEnergyAnalysis`` /
``PathwayBarrierAnalysis``, ``VacancyAnalysis``, ``ConcertedJumpAnalysis``
and ``DetailedBalanceAnalysis`` / ``OccupancyCorrelationAnalysis`` /
``MergeSitesByOccupancyCorrelation``, on the same seeded synthetic hopping
MD and engineered label streams.

Tolerances: every engine but one is host float64 NumPy in both packages
and is held to 1e-12 relative (labels and integers exactly).
``PathwayBarrierAnalysis`` reads a density grid that both packages count
in integers (equal on this input: no atom within an ulp of a bin seam),
and with ``path="string"`` relaxes the strings in float32 on the device:
its nodes are held within 1e-4 Å and its barriers within 1e-4 eV after
20 iterations (``tests/test_torch_mep.py`` holds the strings themselves).
"""
import numpy as np
import pytest
import torch

import sitator_tpu as ref
import sitator_tpu.dynamics as rdyn
import sitator_tpu.io as rio
import sitator_tpu_torch as port
import sitator_tpu_torch.dynamics as pdyn
from sitator_tpu.dynamics import metastable as ref_meta
from sitator_tpu.dynamics import uncertainty as ref_unc
from sitator_tpu_torch.dynamics import metastable as port_meta
from sitator_tpu_torch.dynamics import uncertainty as port_unc

from tests._torch_common import (assert_same_results,
                                 first_math_calls_on_one_thread,
                                 networks, networks_of, trajectories)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

RTOL = 1e-12
KB = 8.617333262e-5


@pytest.fixture(scope="module")
def md():
    return rio.make_hopping_trajectory(n_cells=3, a=4.0, n_ions=6,
                                       n_frames=300, jump_rate=0.05, seed=5)


@pytest.fixture
def hopping(md):
    """Fresh (reference st, port st) with JumpAnalysis run in both."""
    sns = networks_of(md, centers=md.true_sites)
    st_ref, st = trajectories(sns, md.true_assignments, md.traj)
    rdyn.JumpAnalysis(verbose=False).run(st_ref)
    pdyn.JumpAnalysis(verbose=False, device="cpu").run(st)
    return st_ref, st


def both(name, sts, kw=None, port_kw=None, rtol=RTOL, **run_kw):
    """Run engine ``name`` of each package on its own input (``port_kw``
    for the port's only); the engines and what ``run`` returned must
    agree."""
    kw = kw or {}
    out = []
    for dyn, st, extra in zip((rdyn, pdyn), sts, ({}, port_kw or {})):
        engine = getattr(dyn, name)(verbose=False, **kw, **extra)
        out.append((engine, engine.run(st, **run_kw)))
    assert_same_results(out[0], out[1], rtol)
    return out


def test_pcca_memberships_equal():
    rng = np.random.default_rng(0)
    X = np.linalg.qr(rng.normal(size=(9, 3)))[0]
    X[:, 0] = 1.0 / 3.0
    assert_same_results(ref_meta.pcca_memberships(X),
                        port_meta.pcca_memberships(X))


def _basin_traj(basins, n_frames, switch_every):
    labels = np.empty(n_frames, dtype=np.int32)
    b = 0
    for t in range(n_frames):
        if t and t % switch_every == 0:
            b = (b + 1) % len(basins)
        labels[t] = basins[b][t % len(basins[b])]
    return labels[:, None]


def _small_networks(n_sites, seed=0, a=30.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, a, size=(7, 3))
    species = np.array([16] * 6 + [3])
    return networks(pos, species, np.eye(3) * a, species == 16,
                    species == 3, centers=rng.uniform(0, a, (n_sites, 3)))


@pytest.mark.parametrize("kw", [dict(), dict(n_basins=3),
                                dict(n_basins=2, min_timescale=50.0)])
def test_metastability_merge(kw):
    basins = [[0, 1, 2], [3, 4, 5], [6, 7]]
    labels = _basin_traj(basins, 3000, 500)
    sts = trajectories(_small_networks(8), labels)
    both("MergeSitesByMetastability", sts, kw, {"device": "cpu"})


@pytest.mark.parametrize("kw", [dict(), dict(lags=[1, 2, 5, 10],
                                             unknown_policy="break")])
def test_markovianity(kw, hopping):
    both("MarkovianityAnalysis", hopping, kw)


def test_chain_uncertainty_and_edge_intervals(hopping):
    both("ChainUncertaintyAnalysis", hopping,
         dict(observables=("timescales", "stationary", "mfpt"),
              n_samples=40, seed=3), {"device": "cpu"})
    st_ref, st = hopping
    assert_same_results(
        ref_unc.edge_probability_intervals(st_ref, level=0.9),
        port_unc.edge_probability_intervals(st, level=0.9, device="cpu"))
    assert_same_results(st_ref.site_network, st.site_network)
    C = ref_unc.posterior_count_matrix(st_ref.site_network)
    assert_same_results(C, port_unc.posterior_count_matrix(st.site_network))
    assert_same_results(
        ref_unc.sample_transition_matrices(C, 5, np.random.default_rng(1)),
        port_unc.sample_transition_matrices(C, 5, np.random.default_rng(1)))


@pytest.mark.parametrize("n_paths", [1, 4])
def test_transition_paths(n_paths, hopping):
    S = hopping[0].site_network.n_sites
    both("TransitionPathAnalysis", hopping,
         dict(sources=[0, 1], sinks=[S - 1], n_paths=n_paths))


@pytest.mark.parametrize("policy", ["persist", "break"])
def test_residence_times(policy, hopping):
    both("ResidenceTimeAnalysis", hopping,
         dict(min_samples=5, n_mc=40, unknown_policy=policy, seed=2))


def test_arrhenius():
    T = np.array([500.0, 700.0, 900.0, 1100.0])
    D = 3e-3 * np.exp(-0.3 / (KB * T))
    for errors in (None, 0.05 * D):
        want = rdyn.ArrheniusAnalysis(verbose=False).run(T, D, errors)
        got = pdyn.ArrheniusAnalysis(verbose=False).run(T, D, errors)
        assert_same_results(want, got)


def _edge_series(pkg, perms):
    ea = np.array([[np.nan, 0.20, 0.30], [0.25, np.nan, 0.35],
                   [0.15, 0.40, np.nan]])
    nu = np.array([[np.nan, 0.30, 0.50], [0.20, np.nan, 0.40],
                   [0.60, 0.10, np.nan]])
    centers = np.array([[2.0, 2, 2], [6.0, 2, 2], [2.0, 6, 2]])
    series = []
    for T, perm in zip((600.0, 800.0, 1200.0), perms):
        k = nu * np.exp(-ea / (KB * T))
        t_i = np.full(3, 1e6)
        n_ij = k * t_i[:, None]
        np.fill_diagonal(n_ij, 0.0)
        s = pkg.Structure(np.zeros((2, 3)), [16, 3], np.eye(3) * 10.0)
        sn = pkg.SiteNetwork(s, np.array([1, 0], bool),
                             np.array([0, 1], bool))
        sn.centers = centers[perm]
        sn.add_edge_attribute("n_ij", n_ij[np.ix_(perm, perm)])
        sn.add_site_attribute("total_corrected_residences", t_i[perm])
        series.append((T, sn))
    return series


@pytest.mark.parametrize("kw", [dict(), dict(min_counts=5,
                                             match_cutoff=1.0)])
def test_edge_arrhenius(kw):
    perms = [np.array([0, 1, 2]), np.array([2, 0, 1]), np.array([1, 2, 0])]
    want = rdyn.EdgeArrheniusAnalysis(verbose=False, **kw).run(
        _edge_series(ref, perms))
    got = pdyn.EdgeArrheniusAnalysis(verbose=False, **kw).run(
        _edge_series(port, perms))
    assert_same_results(want, got)


@pytest.mark.parametrize("kw", [
    dict(temperature=600.0),
    dict(temperature=600.0, timestep=0.5, attempt_frequency=5.0,
         reference="mean", min_jumps=2)])
def test_site_free_energies(kw, hopping):
    both("SiteFreeEnergyAnalysis", hopping, kw)


@pytest.mark.parametrize("kw", [
    dict(temperature=600.0, n_bins=20, sigma=0.6, min_jumps=2),
    dict(temperature=600.0, n_bins=20, sigma=0.6, max_distance=4.5,
         n_samples=9)])
def test_pathway_barriers_straight(kw, hopping):
    st_ref, st = hopping
    want = rdyn.PathwayBarrierAnalysis(verbose=False, **kw).run(st_ref)
    got = pdyn.PathwayBarrierAnalysis(verbose=False, device="cpu",
                                      **kw).run(st)
    assert_same_results(want, got)
    assert_same_results(st_ref.site_network, st.site_network)
    assert len(got.profiles_) > 0


def test_pathway_barriers_string(hopping):
    st_ref, st = hopping
    kw = dict(temperature=600.0, n_bins=20, sigma=0.6, min_jumps=3,
              n_samples=9, path="string", string_iterations=20)
    want = rdyn.PathwayBarrierAnalysis(verbose=False, **kw).run(st_ref)
    got = pdyn.PathwayBarrierAnalysis(verbose=False, device="cpu",
                                      **kw).run(st)
    assert sorted(got.paths_) == sorted(want.paths_) and got.paths_
    for k in want.paths_:
        np.testing.assert_allclose(got.paths_[k], want.paths_[k], atol=1e-4)
    E_want = st_ref.site_network.density_barrier_ij
    E_got = st.site_network.density_barrier_ij
    np.testing.assert_array_equal(np.isnan(E_got), np.isnan(E_want))
    ok = np.isfinite(E_want)
    np.testing.assert_allclose(E_got[ok], E_want[ok], atol=1e-4)
    assert ok.any()


@pytest.mark.parametrize("kw", [dict(), dict(unknown_policy="strict"),
                                dict(max_step=2)])
def test_vacancies(kw, hopping):
    both("VacancyAnalysis", hopping, kw)


@pytest.mark.parametrize("kw", [dict(), dict(window=3, min_event_size=3),
                                dict(unknown_policy="break")])
def test_concerted_jumps(kw, hopping):
    both("ConcertedJumpAnalysis", hopping, kw)


def test_detailed_balance_and_occupancy_correlation(hopping):
    both("DetailedBalanceAnalysis", hopping, dict(min_events=3))
    both("DetailedBalanceAnalysis", hopping, dict(alpha=0.2))
    both("OccupancyCorrelationAnalysis", hopping, dict(threshold=0.1))
    both("OccupancyCorrelationAnalysis", hopping, dict(), chunk=7)


@pytest.mark.parametrize("kw", [dict(threshold=0.05, distance_threshold=4.5),
                                dict(threshold=0.8)])
def test_merge_by_occupancy_correlation(kw, hopping):
    both("MergeSitesByOccupancyCorrelation", hopping, kw)


def test_validation_matches_reference(hopping):
    st_ref, st = hopping
    for dyn, s in ((rdyn, st_ref), (pdyn, st)):
        with pytest.raises(ValueError, match="temperature"):
            dyn.SiteFreeEnergyAnalysis(temperature=0.0)
        with pytest.raises(ValueError, match="n_samples"):
            dyn.PathwayBarrierAnalysis(temperature=300.0, n_samples=2)
        with pytest.raises(ValueError, match="path"):
            dyn.PathwayBarrierAnalysis(temperature=300.0, path="bogus")
        with pytest.raises(ValueError):
            dyn.TransitionPathAnalysis(sources=[0], sinks=[0])
        with pytest.raises(ValueError):
            dyn.ChainUncertaintyAnalysis(n_samples=1)
        with pytest.raises(ValueError):
            dyn.DetailedBalanceAnalysis(alpha=0.0)
        with pytest.raises(ValueError):
            dyn.EdgeArrheniusAnalysis(min_points=1)
