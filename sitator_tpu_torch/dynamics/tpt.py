"""Transition-path theory on the site network's jump chain.

Beyond the reference surface (upstream ``sitator`` stops at jump
counting; SURVEY.md §3 has no kinetic-pathway machinery): given the
frame-resolution Markov chain measured by
:class:`~sitator_tpu_torch.dynamics.jump_analysis.JumpAnalysis`, discrete
transition-path theory (Metzner, Schütte & Vanden-Eijnden, Multiscale
Model. Simul. 7, 1192 (2009)) answers *how* transport from one site
group to another actually proceeds: the committor of every site, the
reactive-flux network, the A→B transition rate, and the dominant
pathways by repeated widest-path decomposition of the net flux.

All linear algebra is exact host float64 on the ``(S, S)`` chain —
site counts are small; the trajectory-scale work already happened on
device in JumpAnalysis.  This is the right altitude (same as
:mod:`sitator_tpu_torch.dynamics.kmc`).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.dynamics.kmc import (KineticMonteCarlo,
                                      transition_matrix_from_network)

__all__ = ["TransitionPathAnalysis", "committors", "reactive_flux"]

logger = logging.getLogger(__name__)


def committors(P, sources, sinks, pi=None):
    """Forward and backward committors of a row-stochastic chain.

    ``q_plus[i]`` = probability a walker at ``i`` reaches ``sinks``
    before ``sources``; ``q_minus[i]`` = probability the walker at
    ``i`` last came from ``sources`` rather than ``sinks`` (computed on
    the time-reversed chain — for a detailed-balance chain this equals
    ``1 - q_plus``).  Measured chains are routinely reducible: states
    with no mass under ``pi`` (never-visited absorbing rows, abandoned
    transients) and states with no positive-probability path into
    ``sources ∪ sinks`` (isolated recurrent classes, fed-but-absorbing
    sites) are excluded from the linear solves and get ``q = 0`` —
    they carry no reactive flux either way.

    ``pi`` defaults to the power-iterated stationary distribution; for
    a chain measured from a trajectory, pass the empirical occupancy
    measure instead (what :class:`TransitionPathAnalysis` does) — on a
    reducible measured chain the abstract stationary funnels all mass
    into absorbing states, which is not how the data weighted them.

    Returns ``(q_plus, q_minus, pi)``.
    """
    P = np.asarray(P, dtype=np.float64)
    S = len(P)
    if P.shape != (S, S):
        raise ValueError("P must be square")
    if not np.allclose(P.sum(axis=1), 1.0, atol=1e-8):
        raise ValueError("transition matrix must be row-stochastic")
    A = np.zeros(S, dtype=bool)
    A[np.asarray(sources, dtype=int)] = True
    B = np.zeros(S, dtype=bool)
    B[np.asarray(sinks, dtype=int)] = True
    if not A.any() or not B.any():
        raise ValueError("sources and sinks must be non-empty")
    if (A & B).any():
        raise ValueError("sources and sinks must be disjoint")
    if pi is None:
        pi = KineticMonteCarlo._stationary(P)
    live = pi > 1e-9 * pi.max()
    if not (live[A].any() and live[B].any()):
        raise ValueError("sources/sinks have no stationary mass — the "
                         "measured chain never visits them")

    def _can_reach(Pc, boundary):
        """States with a positive-probability path into `boundary`
        (boundary included).  Vectorized BFS, O(S^2) per front."""
        E = Pc > 0.0
        np.fill_diagonal(E, False)
        reach = boundary.copy()
        for _ in range(S):
            new = reach | (E & reach[None, :]).any(axis=1)
            if (new == reach).all():
                break
            reach = new
        return reach

    def _solve(Pc, dirichlet_one):
        """q = Pc q on free states, q=1 on `dirichlet_one`, 0 on the
        other boundary set, 0 off the live class.  Free states are
        restricted to those that can reach the boundary at all —
        without that, a live recurrent class disjoint from A ∪ B
        makes I − P_ff exactly singular."""
        q = np.zeros(S)
        q[dirichlet_one] = 1.0
        free = live & ~A & ~B & _can_reach(Pc, A | B)
        idx = np.flatnonzero(free)
        if len(idx):
            M = np.eye(len(idx)) - Pc[np.ix_(idx, idx)]
            rhs = Pc[np.ix_(idx, np.flatnonzero(dirichlet_one))].sum(
                axis=1)
            q[idx] = np.linalg.solve(M, rhs)
        return np.clip(q, 0.0, 1.0)

    q_plus = _solve(P, B & live)
    # time-reversed chain on the live class; empirical pi is stationary
    # only to O(1/n_frames), so renormalize the rows back to stochastic
    with np.errstate(divide="ignore", invalid="ignore"):
        Pr = np.where(pi[:, None] > 0, pi[None, :] * P.T / pi[:, None],
                      0.0)
        rs = Pr.sum(axis=1, keepdims=True)
        Pr = np.where(rs > 0, Pr / rs, 0.0)
    q_minus = _solve(Pr, A & live)
    return q_plus, q_minus, pi


def reactive_flux(P, q_plus, q_minus, pi):
    """Reactive flux ``f[i, j] = pi_i q-_i P_ij q+_j`` (zero diagonal)
    and its net antisymmetric part ``max(0, f_ij - f_ji)``."""
    P = np.asarray(P, dtype=np.float64)
    f = pi[:, None] * q_minus[:, None] * P * q_plus[None, :]
    np.fill_diagonal(f, 0.0)
    net = np.maximum(0.0, f - f.T)
    return f, net


def _widest_path(net, sources, sinks):
    """Widest (max-min-capacity) path from any source to any sink on
    the net-flux digraph — Dijkstra with the bottleneck metric,
    O(S^2), fine at site-network sizes."""
    S = len(net)
    width = np.full(S, -1.0)
    width[sources] = np.inf
    prev = np.full(S, -1, dtype=int)
    done = np.zeros(S, dtype=bool)
    for _ in range(S):
        cand = np.where(done, -1.0, width)
        u = int(np.argmax(cand))
        if cand[u] <= 0:
            break
        done[u] = True
        w = np.minimum(width[u], net[u])
        better = (w > width) & ~done
        width[better] = w[better]
        prev[better] = u
    best = sinks[int(np.argmax(width[sinks]))]
    if width[best] <= 0:
        return None, 0.0
    path = [int(best)]
    while width[path[-1]] != np.inf:
        path.append(int(prev[path[-1]]))
    return path[::-1], float(width[best])


class TransitionPathAnalysis:
    """TPT over the measured jump chain: committors, reactive flux,
    A→B rate, and dominant pathways.

    Parameters
    ----------
    sources, sinks : disjoint site-index collections (the A and B
        groups — e.g. sites on opposite faces, or two site types).
    n_paths : extract at most this many dominant pathways by repeated
        widest-path removal from the net flux (each pathway's flux is
        its bottleneck capacity; together they account for
        ``path_flux_fraction_`` of the total).

    ``run(st_or_sn)`` needs :class:`JumpAnalysis`'s attributes on the
    network.  Writes the site attribute ``committor`` (forward; NaN on
    zero-mass sites) and edge attribute ``reactive_flux_ij`` (net), and
    exposes ``q_plus_ / q_minus_ / stationary_ / flux_ / net_flux_``,
    ``rate_`` (the TPT reactive flux F — A→B transitions per frame
    *per walker of the single-ion chain*; multiply by the number of
    mobile ions for the system-level count), ``k_AB_`` (F normalized
    by the time the chain spends "coming from A"), and ``pathways_`` —
    list of ``(site_index_list, flux)`` strongest first.  The measure
    used for the flux is the chain's *empirical* occupancy
    (``total_corrected_residences`` normalized) — on a measured,
    possibly reducible chain that is how the data weighted the states,
    where the abstract stationary distribution funnels all mass into
    absorbing rows.  Returns the input.
    """

    def __init__(self, sources, sinks, n_paths=5, verbose=True):
        # unique: a duplicated index would double-count its flux row
        self.sources = np.unique(np.atleast_1d(
            np.asarray(sources, dtype=int)))
        self.sinks = np.unique(np.atleast_1d(
            np.asarray(sinks, dtype=int)))
        if len(np.intersect1d(self.sources, self.sinks)):
            raise ValueError("sources and sinks must be disjoint")
        if not len(self.sources) or not len(self.sinks):
            raise ValueError("sources and sinks must be non-empty")
        self.n_paths = int(n_paths)
        self.verbose = verbose

    def run(self, st_or_sn):
        sn = getattr(st_or_sn, "site_network", st_or_sn)
        S = sn.n_sites
        for grp, name in ((self.sources, "sources"),
                          (self.sinks, "sinks")):
            if grp.min() < 0 or grp.max() >= S:
                raise ValueError(f"{name} out of range for {S} sites")
        P = transition_matrix_from_network(sn)
        t_i = np.asarray(sn.total_corrected_residences,
                         dtype=np.float64)
        pi_emp = t_i / t_i.sum() if t_i.sum() > 0 else None
        q_plus, q_minus, pi = committors(P, self.sources, self.sinks,
                                         pi=pi_emp)
        flux, net = reactive_flux(P, q_plus, q_minus, pi)

        # total reactive flux F = sum of flux out of A (q_plus is 0 on
        # A, so A→A terms vanish; q_minus is 1 on live A by definition)
        self.rate_ = float(flux[self.sources].sum())
        denom = float((pi * q_minus).sum())
        self.k_AB_ = self.rate_ / denom if denom > 0 else np.nan

        self.q_plus_, self.q_minus_, self.stationary_ = (q_plus,
                                                         q_minus, pi)
        self.flux_, self.net_flux_ = flux, net

        # dominant pathways: repeated widest-path removal
        work = net.copy()
        self.pathways_ = []
        for _ in range(self.n_paths):
            path, width = _widest_path(work, self.sources, self.sinks)
            if path is None or width <= 1e-300:
                break
            for u, v in zip(path[:-1], path[1:]):
                work[u, v] -= width
            self.pathways_.append((path, width))
        total_net = float(net[self.sources].sum())
        self.path_flux_fraction_ = (
            sum(w for _, w in self.pathways_) / total_net
            if total_net > 0 else 0.0)

        live = pi > 1e-9 * pi.max()
        for attr in ("committor", "reactive_flux_ij"):
            if attr in sn.site_attributes or attr in sn.edge_attributes:
                sn.remove_attribute(attr)
        sn.add_site_attribute("committor",
                              np.where(live, q_plus, np.nan))
        sn.add_edge_attribute("reactive_flux_ij", net)
        if self.verbose:
            logger.info(
                "TPT: F = %.3g reactive A->B transitions/frame per "
                "ion (k_AB = %.3g), %d pathway(s) carrying %.0f%% of "
                "the net flux", self.rate_, self.k_AB_,
                len(self.pathways_),
                100 * self.path_flux_fraction_)
        return st_or_sn
