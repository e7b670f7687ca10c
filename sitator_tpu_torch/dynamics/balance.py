"""Equilibrium-statistics diagnostics on the site description.

Beyond the reference surface (upstream ``sitator`` stops at raw jump
statistics, SURVEY.md §3.4) — two standard sanity checks of the
literature that come for free from what the pipeline already computed:

- :class:`DetailedBalanceAnalysis` — at equilibrium every edge's
  forward and backward hop counts are exchangeable (time reversal), so
  ``n_ij`` vs ``n_ji`` is Binomial(n_ij + n_ji, 1/2).  Significant
  asymmetry means net steady flux: a field-driven simulation, an
  unequilibrated relaxation, or (most often) a site model that aliased
  two distinct states into one.
- :class:`OccupancyCorrelationAnalysis` — the Pearson correlation of
  per-frame site-occupancy indicators.  Strong negative pairs are
  effective ion–ion exclusion (blocking); strong positive pairs are
  correlated filling (e.g. a split-site pair that is really one site,
  or coupled defects).

Both are one host float64 pass over the label stream / jump counts
(seconds even at 10⁶ frames) and write their results as edge
attributes, the house convention.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitetraj import SiteTrajectory
from sitator_tpu_torch.network.merging import MergeSitesBase as _MergeBase

__all__ = ["DetailedBalanceAnalysis", "OccupancyCorrelationAnalysis",
           "MergeSitesByOccupancyCorrelation"]

logger = logging.getLogger(__name__)


def _binom_two_sided_p(k, n):
    """Two-sided exact binomial p-value for k successes of n at p=1/2
    (vectorized; the doubling-the-smaller-tail convention, capped at 1).
    scipy's regularized-beta CDF — O(1) per edge regardless of event
    count (a naive per-j log-binomial sum is O(n²) and takes seconds
    per busy edge on long runs)."""
    from scipy.stats import binom
    k = np.asarray(k, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    lo = np.minimum(k, n - k)
    with np.errstate(invalid="ignore"):
        tail = binom.cdf(lo, np.maximum(n, 1), 0.5)
    out = np.minimum(1.0, 2.0 * tail)
    return np.where(n == 0, 1.0, out)


class DetailedBalanceAnalysis:
    """Per-edge detailed-balance test on a jump-analyzed network.

    Requires ``n_ij`` (run :class:`JumpAnalysis` first).  After
    ``run(st_or_sn)``:

    - edge attrs on the network: ``edge_asymmetry`` —
      ``(n_ij − n_ji) / (n_ij + n_ji)`` (NaN where no events) — and
      ``balance_p`` (two-sided exact binomial p-value; NaN for edges
      below ``min_events``, so "untested" is never confused with
      "tested and balanced");
    - ``violating_edges_``: ``(k, 2)`` site pairs with
      ``balance_p < alpha`` after a Bonferroni correction over the
      tested edges (conservative on purpose: this flags systematics,
      not noise);
    - ``n_tested_``, ``worst_p_``.  ``run`` returns ``self``.
    """

    def __init__(self, alpha=0.05, min_events=8, verbose=True):
        if not 0 < alpha < 1:
            raise ValueError("alpha must be in (0, 1)")
        self.alpha = float(alpha)
        self.min_events = int(min_events)
        self.verbose = verbose

    def run(self, st_or_sn):
        sn = (st_or_sn.site_network
              if isinstance(st_or_sn, SiteTrajectory) else st_or_sn)
        if not sn.has_attribute("n_ij"):
            raise ValueError("network has no n_ij — run JumpAnalysis "
                             "first")
        n_ij = np.asarray(sn.n_ij, dtype=np.int64).copy()
        np.fill_diagonal(n_ij, 0)
        S = n_ij.shape[0]
        iu = np.triu_indices(S, k=1)
        fwd = n_ij[iu]
        bwd = n_ij.T[iu]
        tot = fwd + bwd
        tested = tot >= self.min_events

        asym = np.full((S, S), np.nan)
        pmat = np.full((S, S), np.nan)
        with np.errstate(invalid="ignore", divide="ignore"):
            a = np.where(tot > 0, (fwd - bwd) / np.maximum(tot, 1),
                         np.nan)
        p = np.full(len(fwd), np.nan)
        p[tested] = _binom_two_sided_p(fwd[tested], tot[tested])
        asym[iu] = a
        asym[(iu[1], iu[0])] = -a
        pmat[iu] = p
        pmat[(iu[1], iu[0])] = p

        self.n_tested_ = int(tested.sum())
        bonf = self.alpha / max(1, self.n_tested_)
        bad = tested & (p < bonf)
        self.violating_edges_ = np.stack(
            [iu[0][bad], iu[1][bad]], axis=1)
        self.worst_p_ = float(p[tested].min()) if self.n_tested_ else \
            float("nan")
        for name in ("edge_asymmetry", "balance_p"):
            if name in sn.edge_attributes:
                sn.remove_attribute(name)
        sn.add_edge_attribute("edge_asymmetry", asym)
        sn.add_edge_attribute("balance_p", pmat)
        if self.verbose:
            logger.info(
                "detailed balance: %d/%d edges violate at "
                "Bonferroni-corrected alpha=%g (worst p = %.3g)",
                len(self.violating_edges_), self.n_tested_, self.alpha,
                self.worst_p_)
        return self


class OccupancyCorrelationAnalysis:
    """Pearson correlation of per-frame site-occupancy indicators.

    After ``run(st)``: edge attr ``occ_corr`` on the network (NaN on
    the diagonal and for never/always-occupied sites, whose indicator
    has zero variance), plus ``exclusive_pairs_`` / ``cofilling_pairs_``
    — site pairs below/above ∓``threshold``.  ``run`` returns ``self``.
    """

    def __init__(self, threshold=0.5, verbose=True):
        if not 0 < threshold <= 1:
            raise ValueError("threshold must be in (0, 1]")
        self.threshold = float(threshold)
        self.verbose = verbose

    def run(self, st: SiteTrajectory, chunk=65536):
        sn = st.site_network
        S = sn.n_sites
        labels = st.traj                   # may be a spilled memmap
        F = labels.shape[0]
        # O(S²) accumulators over frame chunks — the streaming CLI
        # post-processes million-frame label memmaps through here, so
        # a dense (F, S) indicator matrix is not an option
        cross = np.zeros((S, S), dtype=np.float64)
        total = np.zeros(S, dtype=np.float64)
        for lo in range(0, F, chunk):
            blk = np.asarray(labels[lo:lo + chunk])
            C = blk.shape[0]
            occ = np.zeros((C, S), dtype=np.float64)
            ok = blk >= 0
            rows = np.broadcast_to(np.arange(C)[:, None], blk.shape)[ok]
            # multiple ions on one site still give a 0/1 indicator
            occ[rows, blk[ok]] = 1.0
            cross += occ.T @ occ
            total += occ.sum(axis=0)
        mean = total / F
        cov = cross / F - np.outer(mean, mean)
        sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = cov / np.outer(sd, sd)
        corr[~np.isfinite(corr)] = np.nan
        np.fill_diagonal(corr, np.nan)

        iu = np.triu_indices(S, k=1)
        vals = corr[iu]
        lo = np.isfinite(vals) & (vals <= -self.threshold)
        hi = np.isfinite(vals) & (vals >= self.threshold)
        self.exclusive_pairs_ = np.stack([iu[0][lo], iu[1][lo]], axis=1)
        self.cofilling_pairs_ = np.stack([iu[0][hi], iu[1][hi]], axis=1)
        if "occ_corr" in sn.edge_attributes:
            sn.remove_attribute("occ_corr")
        sn.add_edge_attribute("occ_corr", corr)
        if self.verbose:
            logger.info(
                "occupancy correlation: %d exclusive / %d co-filling "
                "pairs beyond |r| >= %g", len(self.exclusive_pairs_),
                len(self.cofilling_pairs_), self.threshold)
        return self


class MergeSitesByOccupancyCorrelation(_MergeBase):
    """Merge co-filled site pairs — the fix for what
    :class:`OccupancyCorrelationAnalysis` diagnoses: a split site (one
    physical basin that clustering cut in two) shows near-perfectly
    POSITIVELY correlated occupancy indicators... for multi-ion systems
    — and, for the common single-basin flicker signature, strong
    ANTI-correlation with rapid back-and-forth hops.  This merger acts
    on the robust symptom: groups of sites whose occupancy correlation
    exceeds ``threshold`` (transitively closed), within the standard
    merge guards (``distance_threshold``, same ``site_types``).

    A thin subclass of the shared merge machinery
    (:class:`~sitator_tpu_torch.network.merging.MergeSitesBase`): everything
    mechanical (occupancy-weighted PBC centers, vertex unions,
    relabeling, attribute remapping) is inherited.
    """

    def __init__(self, threshold=0.8, distance_threshold=2.0,
                 check_types=True, verbose=True):
        _MergeBase.__init__(self, distance_threshold=distance_threshold,
                            check_types=check_types, verbose=verbose)
        if not 0 < threshold <= 1:
            raise ValueError("threshold must be in (0, 1]")
        self.threshold = float(threshold)

    def _get_merges(self, st):
        oc = OccupancyCorrelationAnalysis(
            threshold=self.threshold, verbose=False).run(st)
        S = st.site_network.n_sites
        # union-find over the strongly-correlated pairs (transitive)
        parent = np.arange(S)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i, j in oc.cofilling_pairs_:
            parent[find(i)] = find(j)
        roots = np.array([find(i) for i in range(S)])
        groups = [np.flatnonzero(roots == r) for r in np.unique(roots)]
        return [g for g in groups if len(g) > 1]
