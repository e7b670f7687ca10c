"""Residence-time distribution diagnostics.

Beyond-reference (upstream ``sitator`` reports only mean residence
times, SURVEY.md §3.4): the *distribution* of completed residences at
each site is a physics check of the site decomposition itself.  A true
metastable site visited by a Markovian hopper has geometric
(frame-discrete exponential) residence times; a site that actually
lumps several distinct basins (over-merged / under-resolved) shows
multi-modal or heavy-tailed residences.  This module run-length encodes
the label trajectory, fits the memoryless model per site, and flags
sites whose residence distribution rejects it.

Host-side NumPy (one O(F·M) pass per trajectory — never in the device
hot path).  Significance of the KS statistic against the *fitted*
geometric distribution is calibrated by parametric Monte Carlo (the
classic KS p-value is invalid both for discrete data and for estimated
parameters).
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ResidenceTimeAnalysis", "residence_segments"]


def residence_segments(labels, unknown_policy="persist"):
    """Completed residence lengths per site from a ``(F, M)`` label
    array.

    A residence is a maximal run of consecutive frames an ion spends at
    one site; the first and last run of every ion are **censored**
    (their true length is unknown) and are excluded.  ``unknown_policy``:
    ``'persist'`` forward-fills ``-1`` labels (an unassigned stretch
    does not interrupt a residence — JumpAnalysis parity), ``'break'``
    ends the residence at the first unassigned frame (the following
    run's start is then censored too).

    Returns a list ``segments`` with ``segments[s]`` an int64 array of
    completed residence lengths (frames) at site ``s``.
    """
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError("labels must be (n_frames, n_mobile)")
    if unknown_policy not in ("persist", "break"):
        raise ValueError("unknown_policy must be 'persist' or 'break'")
    n_sites = int(labels.max()) + 1 if labels.size else 0
    out = [[] for _ in range(n_sites)]
    F, M = labels.shape
    if unknown_policy == "persist":
        from sitator_tpu_torch.core.sitetraj import forward_fill_labels
        labels = forward_fill_labels(labels, leading="unknown")
    for m in range(M):
        lab = labels[:, m].astype(np.int64)
        # run-length encode
        change = np.flatnonzero(np.diff(lab) != 0) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [F]])
        sites = lab[starts]
        lengths = ends - starts
        # censor first/last runs, unknown runs, and any run bordering an
        # unknown run (its true start or end is unobserved)
        keep = np.ones(len(starts), dtype=bool)
        keep[0] = keep[-1] = False
        keep &= sites >= 0
        keep &= np.concatenate([[False], sites[:-1] >= 0])
        keep &= np.concatenate([sites[1:] >= 0, [False]])
        for s, n in zip(sites[keep], lengths[keep]):
            out[s].append(int(n))
    return [np.asarray(v, dtype=np.int64) for v in out]


def _ks_vs_geometric(x, p):
    """KS statistic of integer samples ``x`` against Geometric(p)
    (support 1, 2, ...; CDF(k) = 1 - (1-p)^k).  Both CDFs are
    right-continuous step functions, so the exact sup-norm is attained
    either at a distinct sample value v (|F_emp(v) - F(v)|) or just
    below one (|F_emp(v-1) - F(v-1)|, where F_emp is constant on the
    gap and F keeps growing) — the continuous-KS order-statistic
    formula would be wrong here, and a dense scan over 1..max(x) would
    cost O(max residence) per call (this runs n_mc times per site in
    the bootstrap)."""
    x = np.asarray(x, dtype=np.int64)
    n = len(x)
    v = np.unique(x)
    f_emp = np.searchsorted(np.sort(x), v, side="right") / n
    f_emp_prev = np.concatenate([[0.0], f_emp[:-1]])
    q = 1.0 - p
    d_at = np.abs(f_emp - (1.0 - q ** v))
    d_below = np.abs(f_emp_prev - (1.0 - q ** (v - 1)))
    return float(max(d_at.max(), d_below.max()))


class ResidenceTimeAnalysis:
    """Per-site residence-time distributions and memorylessness check.

    Parameters
    ----------
    min_samples : sites with fewer completed residences are reported but
        never flagged (too little data to reject anything).
    alpha : significance level of the Monte-Carlo goodness-of-fit.
    n_mc : parametric-bootstrap replicates per tested site.
    unknown_policy : see :func:`residence_segments`.
    seed : bootstrap PRNG seed.

    After ``run(st)`` (returns ``self``): ``segments_`` (list of arrays),
    ``counts_``, ``mean_``, ``cv_`` (coefficient of variation —
    ``sqrt(1-p)`` for a geometric fit, so ≈1 for long memoryless
    residences), ``ks_``, ``p_value_`` and ``non_exponential_sites_``
    (indices rejecting the memoryless model at ``alpha``).  Writes site
    attributes ``residence_mean`` and ``residence_ks_pvalue`` onto the
    network.  The jump-rate normalization convention matches
    ``JumpAnalysis`` (frames, not time units).
    """

    def __init__(self, min_samples=20, alpha=0.01, n_mc=200,
                 unknown_policy="persist", seed=0, verbose=True):
        if not 0 < alpha < 1:
            raise ValueError("alpha must be in (0, 1)")
        self.min_samples = int(min_samples)
        self.alpha = float(alpha)
        self.n_mc = int(n_mc)
        self.unknown_policy = unknown_policy
        self.seed = int(seed)
        self.verbose = verbose

    def run(self, st):
        sn = st.site_network
        S = sn.n_sites
        segs = residence_segments(st.traj,
                                  unknown_policy=self.unknown_policy)
        segs += [np.empty(0, np.int64)] * (S - len(segs))
        segs = segs[:S]
        rng = np.random.default_rng(self.seed)
        counts = np.array([len(v) for v in segs])
        mean = np.array([v.mean() if len(v) else np.nan for v in segs])
        cv = np.array([v.std() / v.mean()
                       if len(v) and v.mean() > 0 else np.nan
                       for v in segs])
        ks = np.full(S, np.nan)
        pval = np.full(S, np.nan)
        flagged = []
        for s, v in enumerate(segs):
            if len(v) < self.min_samples:
                continue
            p_hat = 1.0 / mean[s]          # geometric MLE on support 1..
            ks[s] = _ks_vs_geometric(v, p_hat)
            # parametric bootstrap: distribution of the KS statistic
            # under the fitted model with re-estimated parameter
            n = len(v)
            null = np.empty(self.n_mc)
            for b in range(self.n_mc):
                sim = rng.geometric(p_hat, size=n)
                null[b] = _ks_vs_geometric(sim, 1.0 / sim.mean())
            pval[s] = float((1 + np.sum(null >= ks[s]))
                            / (1 + self.n_mc))
            if pval[s] < self.alpha:
                flagged.append(s)
        self.segments_ = segs
        self.counts_ = counts
        self.mean_ = mean
        self.cv_ = cv
        self.ks_ = ks
        self.p_value_ = pval
        self.non_exponential_sites_ = np.asarray(flagged, dtype=np.int64)
        for name, arr in (("residence_mean", mean),
                          ("residence_ks_pvalue", pval)):
            if sn.has_attribute(name):
                sn.remove_attribute(name)
            sn.add_site_attribute(name, arr)
        if self.verbose:
            tested = int(np.isfinite(pval).sum())
            logger.info(
                "residences: %d sites tested (>=%d samples), %d reject "
                "memorylessness at alpha=%g%s", tested, self.min_samples,
                len(flagged), self.alpha,
                f" (sites {flagged})" if flagged else "")
        return self
