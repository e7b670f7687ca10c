"""Kinetic Monte Carlo resampling of an analyzed site network
(counterpart of ``sitator_tpu.dynamics.kmc``).

Beyond-reference closure/extrapolation tool (upstream ``sitator`` stops at
the jump statistics, SURVEY.md §3.4): take the frame-resolution Markov
chain that :class:`~sitator_tpu_torch.dynamics.JumpAnalysis` measured — hop
counts ``n_ij`` over total residence frames — and *resample* it on
device.  Uses:

- **closure validation**: re-running ``JumpAnalysis`` /
  ``SiteDiffusionAnalysis`` on the resampled trajectory must reproduce
  the input jump rates, occupancies and site-discretized diffusivity —
  a self-consistency check of the whole site decomposition;
- **statistics extrapolation**: generate arbitrarily many walkers /
  frames from a short MD run to tighten rare-event statistics
  (pathway percolation, barrier estimates) at MD-free cost.

The observed process *at frame resolution* is a discrete-time Markov
chain whose maximum-likelihood transition matrix follows directly from
the JumpAnalysis attributes: ``P[i,j] = n_ij[i,j] / t_i`` for ``j ≠ i``
(``t_i`` = ``total_corrected_residences[i]``, frames spent at ``i``) and
``P[i,i] = 1 − Σ_{j≠i} P[i,j]``.  Simulating THIS chain — rather than an
underlying continuous-time model — makes the closure exact in
expectation: what JumpAnalysis measures on the output converges to what
it measured on the input.

On the device: the walk is a loop over frames on ``device``, all walkers
advanced at once by a Gumbel-max categorical draw — gather the ``(W, S)``
rows of ``log P``, add the noise, arg-max — with the noise drawn from a
``torch.Generator`` seeded with ``seed`` (:func:`_walk_with_noise` is the
same walk on given noise, so a run can be replayed).  The initial sites
are drawn on the host by ``np.random.default_rng(seed)``, as the
reference draws them.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory
from sitator_tpu_torch.core.structure import Structure

logger = logging.getLogger(__name__)

__all__ = ["KineticMonteCarlo", "transition_matrix_from_network",
           "mean_first_passage_times"]


# the noise of one block of steps stays within this many float32 values
_NOISE_ELEMENTS = 2 ** 26


def _log_transition(P, device):
    """float32 ``log P`` (``-inf`` where ``P == 0``) on ``device``.  The
    float64 matrix is cast to float32 BEFORE the log, as the reference
    does (it runs its walk in float32): a log taken in float64 and then
    rounded can differ by an ulp, and near-ties of the arg-max flip."""
    P = np.asarray(P, dtype=np.float64)
    p32 = torch.as_tensor(P.astype(np.float32), device=device)
    live = torch.as_tensor(P > 0, device=device)
    return torch.where(live, torch.log(p32), float("-inf"))


def _noise_block(n_walkers, n_sites):
    """Steps of the walk whose ``(steps, W, S)`` noise is drawn at once."""
    return max(1, _NOISE_ELEMENTS // max(1, n_walkers * n_sites))


def _gumbel(gen, shape, device):
    """Standard Gumbel noise ``−log(−log U)`` in float32 from ``gen``.
    ``U`` is clamped to at least the smallest normal float32, as
    ``jax.random.gumbel`` draws it: ``torch.rand`` can return 0, whose
    noise is +inf, and ``+inf + (−inf)`` at a forbidden transition would
    be a NaN that the arg-max picks."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return u.log_().neg_().log_().neg_()


def _walk_with_noise(logP, s0, gumbel):
    """The walk driven by given noise: ``gumbel`` ``(T, W, S)`` float32,
    ``s0`` ``(W,)`` start sites → ``(T + 1, W)`` int64 labels whose first
    row is ``s0``.  Step ``t`` moves walker ``w`` to
    ``argmax_j(logP[s, j] + gumbel[t, w, j])``; ties go to the first
    index."""
    s = torch.as_tensor(s0, dtype=torch.int64, device=logP.device)
    out = torch.empty((gumbel.shape[0] + 1, len(s)), dtype=torch.int64,
                      device=logP.device)
    out[0] = s
    for t in range(gumbel.shape[0]):
        s = torch.argmax(logP[s] + gumbel[t], dim=1)
        out[t + 1] = s
    return out


def transition_matrix_from_network(sn):
    """Maximum-likelihood frame-resolution transition matrix ``(S, S)``
    from the ``n_ij`` / ``total_corrected_residences`` attributes that
    :class:`JumpAnalysis` wrote onto ``sn``.

    Rows of never-visited sites (zero residence) are made absorbing
    (``P[i,i] = 1``) — a walker can never start there anyway when
    starting from occupancies.  If a row's off-diagonal mass exceeds 1
    (more recorded jumps out of a site than frames spent there — only
    possible for pathological inputs), it is renormalized with a
    warning.
    """
    missing = [a for a in ("n_ij", "total_corrected_residences")
               if not sn.has_attribute(a)]
    if missing:
        raise ValueError("run JumpAnalysis first (needs "
                         + ", ".join(missing) + ")")
    n_ij = np.asarray(sn.n_ij, dtype=np.float64).copy()
    t_i = np.asarray(sn.total_corrected_residences, dtype=np.float64)
    S = sn.n_sites
    if n_ij.shape != (S, S):
        raise ValueError(f"n_ij must be ({S}, {S})")
    np.fill_diagonal(n_ij, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        P = np.where(t_i[:, None] > 0, n_ij / t_i[:, None], 0.0)
    out_mass = P.sum(axis=1)
    bad = out_mass > 1.0
    if bad.any():
        logger.warning(
            "%d site(s) have more recorded jumps than residence frames; "
            "renormalizing their rows", int(bad.sum()))
        P[bad] /= out_mass[bad, None]
        out_mass = P.sum(axis=1)
    idx = np.arange(S)
    P[idx, idx] = 1.0 - out_mass
    # never-visited sites: absorbing rows (diagonal already 1 from above)
    return P


def mean_first_passage_times(P):
    """Mean first-passage time matrix of a discrete-time Markov chain.

    ``M[i, j]`` = expected number of frames for a walker at site ``i``
    to first reach site ``j`` (``M[i, i] = 0``; the mean *recurrence*
    time is ``1/pi_i``).  Computed exactly through the fundamental
    matrix ``Z = (I - P + 1 pi)^{-1}`` (Kemeny & Snell):
    ``M[i, j] = (Z[j, j] - Z[i, j]) / pi_j``.

    States without stationary mass — unreachable absorbing states (how
    never-visited sites are encoded by
    :func:`transition_matrix_from_network`) and *transient* states
    (visited early, abandoned, never re-entered) — are excluded: their
    rows and columns are returned as ``inf``.  The remaining states
    must form ONE recurrent class (the normal case for a chain measured
    from data); a chain with several disconnected recurrent classes
    makes cross-class passage times undefined and raises
    ``LinAlgError`` from the singular fundamental-matrix solve.
    """
    P = np.asarray(P, dtype=np.float64)
    S = len(P)
    if P.shape != (S, S):
        raise ValueError("P must be square")
    if not np.allclose(P.sum(axis=1), 1.0, atol=1e-8):
        raise ValueError("transition matrix must be row-stochastic")
    pi = KineticMonteCarlo._stationary(P)
    M = np.full((S, S), np.inf)
    # relative threshold: transient states' power-iterated mass decays
    # to the convergence floor (~1e-13), not to exact zero — a bare
    # pi > 0 would keep them and divide by that floor, producing huge
    # finite garbage instead of the documented inf
    live = pi > 1e-9 * pi.max()
    if not live.any():
        return M
    idx = np.flatnonzero(live)
    Ps = P[np.ix_(idx, idx)]
    # renormalize in case tiny mass leaks to dead states
    Ps = Ps / Ps.sum(axis=1, keepdims=True)
    pis = pi[idx] / pi[idx].sum()
    n = len(idx)
    Z = np.linalg.inv(np.eye(n) - Ps + np.outer(np.ones(n), pis))
    Ms = (np.diag(Z)[None, :] - Z) / pis[None, :]
    np.fill_diagonal(Ms, 0.0)
    M[np.ix_(idx, idx)] = Ms
    return M


class KineticMonteCarlo:
    """Resample a site network's frame-resolution Markov chain.

    Parameters
    ----------
    n_walkers : independent pseudo-ions to simulate.
    n_frames : frames to generate.
    seed : PRNG seed (deterministic per seed on a given device type).
    start : ``'occupancies'`` (draw initial sites from the measured
        occupancies when present, else stationary), ``'stationary'``
        (left Perron eigenvector of the transition matrix), or an
        explicit ``(n_walkers,)`` integer array of initial sites.
    device : where the walk runs (default ``"cuda"``).
    transition_matrix : optional explicit ``(S, S)`` row-stochastic
        matrix; default is derived from the network's JumpAnalysis
        attributes via :func:`transition_matrix_from_network`.

    ``run(sn)`` returns a :class:`SiteTrajectory` over a pseudo-network:
    the same host structure/static lattice and site centers/types, with
    ``n_walkers`` mobile pseudo-atoms (placed at their initial site
    centers).  Every label-based engine — ``JumpAnalysis``,
    ``SiteDiffusionAnalysis``, ``SiteFreeEnergyAnalysis``, pathway
    analysis — runs on it unchanged.  After ``run``:
    ``transition_matrix_``, ``stationary_`` (the chain's stationary
    distribution), and the returned trajectory's network carries no
    ``vertices`` (the walk never leaves the site graph).
    """

    def __init__(self, n_walkers=64, n_frames=10000, seed=0,
                 start="occupancies", transition_matrix=None,
                 verbose=True, device="cuda"):
        self.n_walkers = int(n_walkers)
        self.n_frames = int(n_frames)
        if self.n_walkers < 1 or self.n_frames < 1:
            raise ValueError("n_walkers and n_frames must be >= 1")
        self.seed = int(seed)
        if not (isinstance(start, str) and start in ("occupancies",
                                                     "stationary")):
            start = np.asarray(start)
            if start.ndim != 1 or len(start) != self.n_walkers:
                raise ValueError("explicit start must be (n_walkers,) "
                                 "site indices")
        self.start = start
        self.transition_matrix = transition_matrix
        self.verbose = verbose
        self.device = device

    # -- chain setup ---------------------------------------------------
    @staticmethod
    def _stationary(P):
        """Stationary distribution by power iteration.

        An eigen-decomposition is wrong for reducible chains: the
        matrices :func:`transition_matrix_from_network` builds make
        never-visited sites *absorbing* (eigenvalue 1 is degenerate) and
        ``argmin(|w-1|)`` could return all-mass-on-an-unreachable-site.
        Instead start uniform over states that are plausibly recurrent —
        excluding unreachable absorbing states (no in-flow, self-loop 1,
        which is exactly how unvisited sites are encoded) — and iterate
        ``pi @ P``; for a reducible chain with several fed recurrent
        classes this converges to the basin-weighted mixture, which is
        the physically sensible resampling default."""
        S = len(P)
        inflow = P.sum(axis=0) - np.diag(P)
        isolated = (inflow <= 0) & (np.diag(P) >= 1.0 - 1e-12)
        pi = np.where(isolated, 0.0, 1.0)
        if pi.sum() == 0:
            pi = np.ones(S)
        pi = pi / pi.sum()
        # lazy chain (P+I)/2: same stationary distribution, provably
        # aperiodic, so the iteration converges even for cyclic P
        for _ in range(20000):
            nxt = 0.5 * (pi + pi @ P)
            nxt = nxt / nxt.sum()
            if np.abs(nxt - pi).max() < 1e-13:
                return nxt
            pi = nxt
        # convergence rate is ~|lambda_2|^n: chains with relaxation
        # timescales beyond ~2e4 frames land here still biased toward
        # the uniform start — never let that pass silently (posterior
        # resampling uses an exact solve instead; see
        # dynamics/uncertainty._obs_stationary)
        logger.warning(
            "stationary power iteration unconverged after 20000 "
            "iterations (slowest relaxation beyond ~2e4 frames); "
            "the returned distribution is approximate")
        return pi

    def _initial_sites(self, sn, P, rng):
        if not isinstance(self.start, str):
            start = np.asarray(self.start, dtype=np.int64)
            if (start < 0).any() or (start >= sn.n_sites).any():
                raise ValueError("start sites out of range")
            return start
        if self.start == "occupancies" and sn.has_attribute("occupancies"):
            p = np.asarray(sn.occupancies, dtype=np.float64)
            p = np.where(p > 0, p, 0.0)
        else:
            p = self._stationary(P)
        if p.sum() <= 0:
            p = np.ones(sn.n_sites)
        p = p / p.sum()
        return rng.choice(sn.n_sites, size=self.n_walkers, p=p)

    # -- the walk (device) ----------------------------------------------
    @staticmethod
    def _walk(P, s0, n_frames, seed, device="cuda"):
        """(F, W) int32 labels: a Gumbel-max categorical walk on
        ``device``, its noise drawn block by block from a
        ``torch.Generator`` on ``device`` seeded with ``seed`` (one block
        of :func:`_noise_block` steps at a time, so the noise never
        holds more than ~256 MB)."""
        device = torch.device(device)
        logP = _log_transition(P, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        W, S = len(s0), logP.shape[1]
        s = torch.as_tensor(np.asarray(s0), dtype=torch.int64,
                            device=device)
        out = [s[None]]
        block = _noise_block(W, S)
        for lo in range(0, n_frames - 1, block):
            g = _gumbel(gen, (min(block, n_frames - 1 - lo), W, S), device)
            labels = _walk_with_noise(logP, s, g)
            out.append(labels[1:])
            s = labels[-1]
        return torch.cat(out).to(torch.int32).cpu().numpy()

    # -- pseudo-network --------------------------------------------------
    @staticmethod
    def _pseudo_network(sn, init_sites, n_walkers):
        host = sn.structure
        static_idx = np.flatnonzero(sn.static_mask)
        mobile_species = (host.species[sn.mobile_mask][0]
                          if sn.n_mobile else 0)
        pos = np.concatenate([host.positions[static_idx],
                              np.asarray(sn.centers)[init_sites]], axis=0)
        species = np.concatenate([host.species[static_idx],
                                  np.full(n_walkers, mobile_species,
                                          dtype=np.int32)])
        structure = Structure(pos, species, host.cell, pbc=host.pbc)
        n_static = len(static_idx)
        static_mask = np.zeros(n_static + n_walkers, dtype=bool)
        static_mask[:n_static] = True
        out = SiteNetwork(structure, static_mask, ~static_mask)
        out.centers = np.asarray(sn.centers).copy()
        if sn.site_types is not None:
            out.site_types = sn.site_types.copy()
        return out

    def run(self, sn):
        if sn.n_sites < 1:
            raise ValueError("site network has no sites")
        P = (transition_matrix_from_network(sn)
             if self.transition_matrix is None
             else np.asarray(self.transition_matrix, dtype=np.float64))
        if P.shape != (sn.n_sites, sn.n_sites):
            raise ValueError("transition matrix must be "
                             f"({sn.n_sites}, {sn.n_sites})")
        rowsum = P.sum(axis=1)
        if not np.allclose(rowsum, 1.0, atol=1e-8) or (P < -1e-12).any():
            raise ValueError("transition matrix must be row-stochastic")
        rng = np.random.default_rng(self.seed)
        s0 = self._initial_sites(sn, P, rng)
        labels = self._walk(P, s0, self.n_frames, self.seed,
                            device=self.device)
        self.transition_matrix_ = P
        self.stationary_ = self._stationary(P)
        out_sn = self._pseudo_network(sn, s0, self.n_walkers)
        st = SiteTrajectory(out_sn, labels)
        if self.verbose:
            n_hops = int((labels[1:] != labels[:-1]).sum())
            logger.info(
                "KMC: %d walkers x %d frames on %d sites, %d hops "
                "(%.4g per walker-frame)", self.n_walkers, self.n_frames,
                sn.n_sites, n_hops,
                n_hops / (self.n_walkers * max(1, self.n_frames - 1)))
        return st
