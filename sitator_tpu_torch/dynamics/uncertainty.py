"""Bayesian uncertainty for everything derived from the measured chain.

Beyond the reference surface (upstream ``sitator`` reports point
estimates only; SURVEY.md §3.4): the standard Markov-state-model
uncertainty machinery (Noé, J. Chem. Phys. 128, 244103 (2008)).  The
observed frame-resolution transitions are multinomial per row, so the
posterior over each transition-matrix row is an independent Dirichlet
over the observed counts (plus a pseudo-count prior); sampling rows and
re-evaluating any observable propagates the *finite-sampling* error of
the trajectory into that observable exactly — no linearization, no
independence assumption between the matrix entries an observable
couples.

Two layers:

- :func:`edge_probability_intervals` — per-edge credible intervals on
  ``p_ij``, analytic (each entry's marginal is Beta): zero extra
  sampling cost, written as edge attributes.
- :class:`ChainUncertaintyAnalysis` — Monte-Carlo posterior over whole-
  chain observables (implied timescales, stationary occupancies, mean
  first-passage times, or any user callable of ``P``).

All host NumPy float64: the trajectory-scale device work already
happened in :class:`~sitator_tpu_torch.dynamics.JumpAnalysis`; site counts
are small (same altitude as :mod:`sitator_tpu_torch.dynamics.kmc`).
"""
from __future__ import annotations

import logging
from contextlib import contextmanager as _contextmanager

import numpy as np

from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis
from sitator_tpu_torch.dynamics.kmc import (KineticMonteCarlo,
                                      mean_first_passage_times)

__all__ = ["ChainUncertaintyAnalysis", "sample_transition_matrices",
           "edge_probability_intervals", "posterior_count_matrix"]

logger = logging.getLogger(__name__)


def _jump_analyzed(st_or_sn, device="cuda"):
    """Network with jump statistics: run :class:`JumpAnalysis` (on
    ``device``) on a trajectory that lacks them; a bare network must
    already carry them (there is no trajectory to measure)."""
    sn = getattr(st_or_sn, "site_network", st_or_sn)
    if not sn.has_attribute("n_ij"):
        if sn is st_or_sn:
            raise ValueError("bare SiteNetwork without n_ij — run "
                             "JumpAnalysis first or pass the "
                             "SiteTrajectory")
        JumpAnalysis(verbose=False, device=device).run(st_or_sn)
    return sn


def posterior_count_matrix(sn):
    """Frame-resolution transition *count* matrix from a jump-analyzed
    network: off-diagonal ``n_ij``, diagonal = residence frames not
    spent jumping (clipped at 0).  Each row is the multinomial evidence
    for that site's transition distribution."""
    missing = [a for a in ("n_ij", "total_corrected_residences")
               if not sn.has_attribute(a)]
    if missing:
        raise ValueError("run JumpAnalysis first (needs "
                         + ", ".join(missing) + ")")
    C = np.asarray(sn.n_ij, dtype=np.float64).copy()
    t_i = np.asarray(sn.total_corrected_residences, dtype=np.float64)
    np.fill_diagonal(C, 0.0)
    np.fill_diagonal(C, np.maximum(t_i - C.sum(axis=1), 0.0))
    return C


def sample_transition_matrices(C, n_samples, rng, prior=None):
    """Dirichlet posterior samples of the row-stochastic transition
    matrix given count matrix ``C``: ``P[s, i] ~ Dir(C[i] + prior)``.

    ``prior`` is the per-entry pseudo-count; default ``1/S`` (the
    "neutral" prior whose total row weight is one frame — vanishing
    against any observed row, proper on unobserved ones).  Rows with no
    evidence at all sample as absorbing (``P[i, i] = 1``), matching
    :func:`~sitator_tpu_torch.dynamics.kmc.transition_matrix_from_network`'s
    encoding of never-visited sites.  Returns ``(n_samples, S, S)``.
    """
    C = np.asarray(C, dtype=np.float64)
    S = len(C)
    if prior is None:
        prior = 1.0 / S
    if float(prior) < 0.0:
        raise ValueError(f"prior must be >= 0, got {prior}")
    alpha = C + float(prior)
    # gamma-normalize: rows of iid Gamma(alpha) normalized are Dirichlet
    g = rng.standard_gamma(alpha[None, :, :],
                           size=(n_samples, S, S))
    dead = C.sum(axis=1) == 0
    if dead.any():
        # never-visited sites stay fully disconnected (absorbing AND
        # unreachable), matching transition_matrix_from_network: prior
        # mass leaking INTO an absorbing state would otherwise siphon
        # the stationary distribution and corrupt every sampled
        # observable (MFPTs, timescales) with near-singular chains
        g[:, dead, :] = 0.0
        g[:, :, dead] = 0.0
        g[:, dead, np.flatnonzero(dead)] = 1.0
    return g / g.sum(axis=2, keepdims=True)


def edge_probability_intervals(st_or_sn, level=0.95, prior=None,
                               add_attributes=True, device="cuda"):
    """Analytic per-edge credible intervals on the per-frame jump
    probability ``p_ij``.

    Each matrix entry's Dirichlet marginal is
    ``Beta(C_ij + prior, C_i - C_ij + (S_live - 1) prior)`` where
    ``S_live`` counts the live (ever-visited) columns — never-visited
    columns are excluded from the Dirichlet support entirely (matching
    :func:`sample_transition_matrices`), so only live columns carry
    prior pseudo-mass.  The interval is its equal-tailed ``level``
    quantile pair.  With
    ``add_attributes=True`` (default) writes ``p_ij_lo`` / ``p_ij_hi``
    edge attributes onto the network and returns ``(lo, hi)``.

    Note these are *per-frame transition* probabilities (the ``n_ij /
    total_corrected_residences`` rate), the Bayesian companion of the
    chain every downstream engine consumes — not the reference's
    jump-conditioned ``p_ij`` row normalization.  A trajectory without
    jump statistics gets them from :class:`JumpAnalysis` on ``device``.
    """
    from scipy.stats import beta as _beta
    sn = _jump_analyzed(st_or_sn, device)
    C = posterior_count_matrix(sn)
    S = len(C)
    if prior is None:
        prior = 1.0 / S
    a = C + prior
    row = C.sum(axis=1, keepdims=True)
    dead = row[:, 0] == 0
    # the sampled posterior zeroes dead (never-visited) columns out of
    # the Dirichlet support, so the Beta complement must count only the
    # live columns' pseudo-mass — (S-1)*prior would shift lo/hi downward
    # on weakly-sampled edges whenever dead sites exist
    S_live = S - int(dead.sum())
    tail = 0.5 * (1.0 - float(level))
    if S_live == 1:
        # degenerate corner: one live site, whose self-transition is
        # deterministically 1 (the Beta b-parameter would be 0 and
        # beta.ppf would return NaN for a certain probability)
        lo = np.full_like(a, np.nan)
        hi = np.full_like(a, np.nan)
        li = np.flatnonzero(~dead)
        lo[li, li] = hi[li, li] = 1.0
    else:
        b = row - C + (S_live - 1) * prior
        lo = _beta.ppf(tail, a, b)
        hi = _beta.ppf(1.0 - tail, a, b)
        lo[dead], hi[dead] = np.nan, np.nan
        lo[:, dead], hi[:, dead] = np.nan, np.nan  # structurally no mass
    if add_attributes:
        sn.add_edge_attribute("p_ij_lo", lo)
        sn.add_edge_attribute("p_ij_hi", hi)
    return lo, hi


def _live_states(P):
    """Mask of states that are NOT isolated absorbing (no in-flow,
    self-loop 1) — exactly how :func:`sample_transition_matrices`
    encodes never-visited sites.  Observables must restrict to this
    block: each dead state contributes a degenerate unit eigenvalue
    (a bogus ~1e15-frame 'slowest timescale') and an arbitrary share
    of the stationary mass otherwise."""
    inflow = P.sum(axis=0) - np.diag(P)
    return ~((inflow <= 0) & (np.diag(P) >= 1.0 - 1e-12))


def _obs_timescales(n_timescales):
    def timescales(P):
        live = _live_states(P)
        Pl = P[np.ix_(live, live)]
        lam = np.sort(np.abs(np.linalg.eigvals(Pl)))[::-1]
        lam = lam[1:]
        # with prior=0 the live block can be REDUCIBLE (alpha=0 gamma
        # draws are exactly 0): each extra connected component carries
        # its own unit eigenvalue — a degenerate mode, not a timescale
        lam = lam[lam < 1.0 - 1e-12]
        lam = np.clip(lam[:n_timescales], 1e-12, 1.0 - 1e-15)
        out = np.full(n_timescales, np.nan)
        out[:len(lam)] = -1.0 / np.log(lam)
        return out
    return timescales


def _obs_stationary(P):
    """Exact stationary distribution of one posterior draw.

    The live block of a sampled ``P`` is strictly positive (Dirichlet
    rows), hence irreducible with a unique stationary vector — solve it
    exactly.  Power iteration (``KineticMonteCarlo._stationary``) is
    kept only as the singular-matrix fallback: its bounded iteration
    leaves chains with timescales beyond ~2e4 frames unconverged, which
    biased every posterior draw identically toward uniform and produced
    confidently-wrong credible intervals."""
    P = np.asarray(P, dtype=np.float64)
    S = len(P)
    live = _live_states(P)
    if not live.any():
        return np.full(S, np.nan)
    Pl = P[np.ix_(live, live)]
    n = len(Pl)
    A = Pl.T - np.eye(n)
    A[-1, :] = 1.0
    b = np.zeros(n)
    b[-1] = 1.0
    try:
        pi_l = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        pi_l = KineticMonteCarlo._stationary(Pl)
    pi_l = np.clip(pi_l, 0.0, None)
    s = pi_l.sum()
    if not np.isfinite(s) or s <= 0:
        pi_l = KineticMonteCarlo._stationary(Pl)
        s = pi_l.sum()
    out = np.zeros(S)
    out[live] = pi_l / s
    return out


def _obs_mfpt(P):
    return mean_first_passage_times(P)


class ChainUncertaintyAnalysis:
    """Posterior (finite-sampling) uncertainty of chain observables.

    Parameters
    ----------
    observables : iterable of names and/or callables.  Built-ins:
        ``'timescales'`` (implied relaxation timescales, frames),
        ``'stationary'`` (stationary site occupancy distribution),
        ``'mfpt'`` (mean first-passage time matrix; ``inf`` entries for
        unreachable pairs are excluded from the statistics per-sample).
        A callable receives one sampled row-stochastic ``P`` and
        returns an array; its ``__name__`` keys the results.
    n_samples : posterior draws (default 200).
    prior : Dirichlet pseudo-count per entry (default ``1/S``).
    n_timescales : modes for the ``'timescales'`` observable.
    level : credible-interval mass (default 0.95, equal-tailed).
    seed : RNG seed.
    device : where :class:`JumpAnalysis` runs when the input lacks jump
        statistics (default ``"cuda"``); the sampling is host float64.

    After ``run(st_or_sn)`` (returns ``self``): ``samples_[name]``
    (stacked draws), ``mean_[name]``, ``std_[name]``, ``ci_[name]``
    (``(lo, hi)`` arrays).  NaN/inf sample entries are excluded
    per-element (``nan*`` statistics); an entry infinite in *every*
    draw reports ``inf`` mean and NaN bounds.
    """

    def __init__(self, observables=("timescales", "stationary"),
                 n_samples=200, prior=None, n_timescales=3,
                 level=0.95, seed=0, verbose=True, device="cuda"):
        self.observables = tuple(observables)
        if not self.observables:
            raise ValueError("need at least one observable")
        self.n_samples = int(n_samples)
        if self.n_samples < 2:
            raise ValueError("n_samples must be >= 2")
        self.prior = prior
        self.n_timescales = int(n_timescales)
        self.level = float(level)
        if not 0.0 < self.level < 1.0:
            raise ValueError("level must be in (0, 1)")
        self.seed = seed
        self.verbose = verbose
        self.device = device

    def _resolve(self, obs):
        if callable(obs):
            return getattr(obs, "__name__", "observable"), obs
        if obs == "timescales":
            return obs, _obs_timescales(self.n_timescales)
        if obs == "stationary":
            return obs, _obs_stationary
        if obs == "mfpt":
            return obs, _obs_mfpt
        raise ValueError(f"unknown observable {obs!r} (use "
                         "'timescales'/'stationary'/'mfpt' or a "
                         "callable)")

    def run(self, st_or_sn):
        sn = _jump_analyzed(st_or_sn, self.device)
        C = posterior_count_matrix(sn)
        rng = np.random.default_rng(self.seed)
        Ps = sample_transition_matrices(C, self.n_samples, rng,
                                        prior=self.prior)
        named = [self._resolve(o) for o in self.observables]
        self.samples_, self.mean_, self.std_, self.ci_ = {}, {}, {}, {}
        tail = 0.5 * (1.0 - self.level)
        for name, fn in named:
            vals = np.stack([np.asarray(fn(P), dtype=np.float64)
                             for P in Ps])
            self.samples_[name] = vals
            finite = np.where(np.isfinite(vals), vals, np.nan)
            with np.errstate(invalid="ignore"), \
                    _suppress_all_nan_warnings():
                self.mean_[name] = np.nanmean(finite, axis=0)
                self.std_[name] = np.nanstd(finite, axis=0)
                lo = np.nanquantile(finite, tail, axis=0)
                hi = np.nanquantile(finite, 1.0 - tail, axis=0)
            # all-draws-infinite entries: genuinely unreachable
            all_inf = np.isinf(vals).all(axis=0)
            if all_inf.any():
                self.mean_[name] = np.where(all_inf, np.inf,
                                            self.mean_[name])
            self.ci_[name] = (lo, hi)
        if self.verbose:
            for name, _ in named:
                m = self.mean_[name]
                logger.info("uncertainty[%s]: mean %s, 95%% CI width "
                            "median %s (%d draws)", name,
                            np.array2string(np.atleast_1d(m).ravel()[:4],
                                            precision=3),
                            _fmt_width(self.ci_[name]),
                            self.n_samples)
        return self


def _fmt_width(ci):
    lo, hi = ci
    w = np.asarray(hi) - np.asarray(lo)
    w = w[np.isfinite(w)]
    return f"{np.median(w):.3g}" if w.size else "n/a"


@_contextmanager
def _suppress_all_nan_warnings():
    """``nanmean``/``nanquantile`` of an all-NaN column warn; the NaN
    result is the documented, wanted answer here."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield
