"""The port's ``KineticMonteCarlo`` and chain helpers
(``dynamics/kmc.py``) against the JAX package's, on the CPU.

- The initial sites come from ``np.random.default_rng(seed)`` in both
  packages: equal.
- The walk: the port draws its Gumbel noise from a ``torch.Generator``, the
  reference from ``jax.random``, so their labels differ by design.  Fed the
  reference's own noise — ``jax.random.gumbel(k, (W, S), float32)`` over
  ``jax.random.split(PRNGKey(seed), n_frames - 1)`` — the port's
  noise-driven walk must give the reference's labels exactly.
- The port's own generator is held statistically: transition
  frequencies within 5 binomial σ of P, no step where P = 0, and the
  random-walk diffusivity of ``tests/test_kmc.py``.
- The chain helpers are host float64: 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitator_tpu as ref
import sitator_tpu_torch as port
from sitator_tpu.dynamics import kmc as ref_kmc
from sitator_tpu_torch.dynamics import kmc as pk

from tests._torch_common import (assert_same_results,
                                 first_math_calls_on_one_thread)

torch.set_num_threads(2)
first_math_calls_on_one_thread()

CPU = torch.device("cpu")


def _networks(centers, cell_size=20.0):
    out = []
    for pkg in (ref, port):
        s = pkg.Structure(np.zeros((2, 3)), [16, 3], np.eye(3) * cell_size)
        sn = pkg.SiteNetwork(s, np.array([1, 0], bool),
                             np.array([0, 1], bool))
        sn.centers = np.asarray(centers, dtype=np.float64)
        out.append(sn)
    return out


def _sparse_chain(seed, S):
    """A row-stochastic chain with forbidden transitions."""
    rng = np.random.default_rng(seed)
    P = rng.random((S, S)) * (rng.random((S, S)) < 0.5)
    np.fill_diagonal(P, rng.random(S) + 0.5)
    return P / P.sum(1, keepdims=True)


def _jax_noise(seed, n_frames, W, S):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_frames - 1)
    return np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (W, S), jnp.float32))(keys))


def _lattice_walk(n=4, a=3.0, p=0.05):
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    S = len(grid)
    P = np.zeros((S, S))
    idx = {tuple(g): i for i, g in enumerate(grid)}
    for i, g in enumerate(grid):
        for d in range(3):
            for sgn in (-1, 1):
                h = g.copy()
                h[d] = (h[d] + sgn) % n
                P[i, idx[tuple(h)]] += p
        P[i, i] = 1.0 - 6 * p
    return (grid + 0.5) * a, n * a, P


@pytest.mark.parametrize("seed,S,W,F", [(0, 6, 16, 120), (1, 9, 7, 80),
                                        (2, 3, 32, 60)])
def test_log_transition_and_replayed_noise(seed, S, W, F):
    P = _sparse_chain(seed, S)
    s0 = np.random.default_rng(seed).integers(0, S, W)
    logP = pk._log_transition(P, CPU)
    want_logP = np.asarray(jnp.where(P > 0, jnp.log(jnp.maximum(P, 1e-300)),
                                     -jnp.inf).astype(jnp.float32))
    assert logP.dtype == torch.float32
    np.testing.assert_array_equal(torch.isinf(logP).numpy(),
                                  np.isinf(want_logP))
    fin = np.isfinite(want_logP)
    np.testing.assert_array_max_ulp(logP.numpy()[fin], want_logP[fin], 1)
    got = pk._walk_with_noise(logP, torch.as_tensor(s0),
                              torch.as_tensor(_jax_noise(seed, F, W, S)))
    want = ref_kmc.KineticMonteCarlo._walk(P, s0, F, seed)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", ["occupancies", "stationary", "explicit"])
def test_run_equals_reference_on_its_noise(start, monkeypatch):
    """The whole ``run``: the same start sites from the same seed, the same
    pseudo-network, and on the reference's noise the same labels."""
    S, W, F, seed = 5, 12, 50, 11
    P = _sparse_chain(3, S)
    sns = _networks(np.random.default_rng(0).uniform(0, 20, (S, 3)))
    for sn in sns:
        sn.add_site_attribute("occupancies", np.arange(1.0, S + 1))
        sn.site_types = np.arange(S, dtype=np.int32) % 2
    st0 = (np.arange(W) % S) if start == "explicit" else start
    noise = torch.as_tensor(_jax_noise(seed, F, W, S))
    monkeypatch.setattr(pk, "_gumbel", lambda gen, shape, device: noise)
    kw = dict(n_walkers=W, n_frames=F, seed=seed, start=st0,
              transition_matrix=P, verbose=False)
    want_kmc = ref_kmc.KineticMonteCarlo(**kw)
    got_kmc = pk.KineticMonteCarlo(device="cpu", **kw)
    want, got = want_kmc.run(sns[0]), got_kmc.run(sns[1])
    assert isinstance(got, port.SiteTrajectory)
    assert got.traj.dtype == want.traj.dtype == np.int32
    assert_same_results(want, got)
    assert_same_results(want_kmc, got_kmc)
    np.testing.assert_array_equal(got.site_network.structure.positions,
                                  want.site_network.structure.positions)


def test_gumbel_clamps_a_zero_draw(monkeypatch):
    """``torch.rand`` may return 0; its noise must stay finite so that a
    forbidden transition (−inf) is never picked through a NaN."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.zeros(
        k.get("size", a[0]), dtype=torch.float32))
    g = pk._gumbel(gen, (2, 3, 4), CPU)
    assert torch.isfinite(g).all()
    tiny = torch.tensor(torch.finfo(torch.float32).tiny)
    assert torch.equal(g, torch.full_like(g, float(-(-tiny.log()).log())))
    logP = torch.log(torch.tensor([[0.5, 0.5, 0.0, 0.0]] * 4))
    walk = pk._walk_with_noise(logP, torch.zeros(3, dtype=torch.int64), g)
    assert (walk < 2).all()


def test_ties_go_to_the_first_index():
    logP = torch.zeros(3, 3)
    walk = pk._walk_with_noise(logP, torch.tensor([2, 1]),
                               torch.zeros(4, 2, 3))
    np.testing.assert_array_equal(walk.numpy(), [[2, 1]] + [[0, 0]] * 4)


def test_walk_blocks_and_determinism(monkeypatch):
    """The noise is drawn in blocks; the walk is deterministic by seed and
    does not depend on the block size's fit to the frame count."""
    P = _sparse_chain(4, 7)
    s0 = np.arange(10) % 7
    a = pk.KineticMonteCarlo._walk(P, s0, 90, 5, device="cpu")
    b = pk.KineticMonteCarlo._walk(P, s0, 90, 5, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.shape == (90, 10)
    np.testing.assert_array_equal(a[0], s0)
    c = pk.KineticMonteCarlo._walk(P, s0, 90, 6, device="cpu")
    assert not np.array_equal(a, c)
    monkeypatch.setattr(pk, "_NOISE_ELEMENTS", 7 * 10 * 4)   # 4 steps
    assert pk._noise_block(10, 7) == 4
    blocked = pk.KineticMonteCarlo._walk(P, s0, 90, 5, device="cpu")
    assert blocked.shape == (90, 10)
    np.testing.assert_array_equal(blocked[0], s0)


def test_transition_frequencies_within_five_sigma():
    P = _sparse_chain(6, 8)
    W, F = 64, 2000
    labels = pk.KineticMonteCarlo._walk(P, np.arange(W) % 8, F, 7,
                                        device="cpu")
    frm, to = labels[:-1].ravel(), labels[1:].ravel()
    counts = np.zeros((8, 8))
    np.add.at(counts, (frm, to), 1)
    assert (counts[P == 0] == 0).all()            # never a forbidden step
    visits = counts.sum(1)
    rows = visits >= 1000
    assert rows.sum() >= 6
    sigma = np.sqrt(P * (1 - P) / np.maximum(visits, 1)[:, None])
    dev = np.abs(counts / np.maximum(visits, 1)[:, None] - P)
    assert (dev[rows] <= 5 * sigma[rows] + 1e-12).all()


def test_site_diffusivity_matches_random_walk():
    """``tests/test_kmc.py``'s lattice walk on the port's own generator:
    ``SiteDiffusionAnalysis`` recovers D = p a²."""
    from sitator_tpu_torch.dynamics import SiteDiffusionAnalysis
    centers, L, P = _lattice_walk()
    sn = _networks(centers, cell_size=L)[1]
    st = pk.KineticMonteCarlo(n_walkers=128, n_frames=4000, seed=3,
                              start="stationary", transition_matrix=P,
                              verbose=False, device="cpu").run(sn)
    da = SiteDiffusionAnalysis(timestep=1.0, fit_range=(0.02, 0.2),
                               verbose=False).run(st)
    assert da.D_site_ == pytest.approx(0.05 * 3.0 ** 2, rel=0.05)


def test_chain_helpers_equal():
    S = 6
    sns = _networks(np.random.default_rng(1).uniform(0, 20, (S, 3)))
    rng = np.random.default_rng(2)
    n_ij = rng.integers(0, 20, (S, S)).astype(np.float64)
    t_i = rng.uniform(50, 200, S)
    t_i[4] = 0.0                                     # never visited
    n_ij[5] = 500.0                                  # renormalised row
    for sn in sns:
        sn.add_edge_attribute("n_ij", n_ij)
        sn.add_site_attribute("total_corrected_residences", t_i)
    P = ref_kmc.transition_matrix_from_network(sns[0])
    assert_same_results(P, pk.transition_matrix_from_network(sns[1]))
    for M in (P, _sparse_chain(0, 5), np.array([[0.5, 0.5], [0.0, 1.0]])):
        assert_same_results(ref_kmc.mean_first_passage_times(M),
                            pk.mean_first_passage_times(M))
        assert_same_results(ref_kmc.KineticMonteCarlo._stationary(M),
                            pk.KineticMonteCarlo._stationary(M))


def test_validation_matches_reference():
    sns = _networks([[2.0, 2, 2], [6.0, 6, 6]])
    P = np.array([[0.9, 0.1], [0.2, 0.8]])
    for mod, sn, kw in ((ref_kmc, sns[0], {}),
                        (pk, sns[1], {"device": "cpu"})):
        KMC = mod.KineticMonteCarlo
        with pytest.raises(ValueError, match="row-stochastic"):
            KMC(transition_matrix=np.eye(2) * 0.5, verbose=False,
                **kw).run(sn)
        with pytest.raises(ValueError, match="must be \\(2, 2\\)"):
            KMC(transition_matrix=np.eye(3), verbose=False, **kw).run(sn)
        with pytest.raises(ValueError, match="n_walkers"):
            KMC(n_walkers=0, **kw)
        with pytest.raises(ValueError, match="must be \\(n_walkers"):
            KMC(n_walkers=4, start=np.array([0, 1]), **kw)
        with pytest.raises(ValueError, match="out of range"):
            KMC(n_walkers=2, transition_matrix=P, start=np.array([0, 5]),
                verbose=False, **kw).run(sn)
        with pytest.raises(ValueError, match="no sites"):
            KMC(verbose=False, **kw).run(type(sn)(
                sn.structure, sn.static_mask, sn.mobile_mask))
        with pytest.raises(ValueError, match="JumpAnalysis first"):
            mod.transition_matrix_from_network(sn)
        with pytest.raises(ValueError, match="row-stochastic"):
            mod.mean_first_passage_times(np.eye(2) * 0.5)
