"""Spectral metastability analysis and merging (PCCA-style).

Beyond the reference surface (upstream ``sitator`` merges by Markov
clustering only; SURVEY.md §3.4): the Markov-state-model route to the
same question — which groups of sites form single kinetic basins?  The
slow right eigenvectors of the measured frame-resolution chain are
nearly constant on metastable basins (Perron cluster analysis:
Deuflhard & Weber, Lin. Alg. Appl. 398, 161 (2005)), so clustering
their rows recovers the basins *and* says how many there are (the
spectral gap) — two things MCL's inflation knob can only be tuned
toward.

Everything runs on the reversibilized empirical chain: with the
empirical measure ``pi ∝ total_corrected_residences``, the
pi-reversibilization ``(diag(pi) P + Pᵀ diag(pi)) / 2`` is exactly the
symmetrized count matrix ``(n_ij + n_ji) / 2`` with the residence
self-loops on the diagonal — real spectrum, one small ``eigh`` on the
host (site counts are small; the trajectory-scale work already
happened on device in JumpAnalysis — same altitude as
:mod:`sitator_tpu_torch.dynamics.kmc`).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis
from sitator_tpu_torch.network.merging import MergeSitesBase

__all__ = ["MergeSitesByMetastability", "pcca_memberships"]

logger = logging.getLogger(__name__)


def pcca_memberships(X):
    """Inner-simplex PCCA memberships from right-eigenvector rows.

    ``X`` is ``(m, n)``: one row per state, the top-``n`` right
    eigenvectors of a reversible chain (first column ~ constant).  In
    this coordinate system metastable states populate the vertices of
    an (n-1)-simplex; the classical deterministic vertex hunt picks the
    row farthest from the centroid, then repeatedly the row farthest
    from the affine span of the vertices found so far.  Returns
    ``(chi, vertex_rows)`` where ``chi = X @ pinv(X[vertices])`` are
    barycentric memberships — crisp labels are ``argmax(chi, axis=1)``.
    """
    X = np.asarray(X, dtype=np.float64)
    m, n = X.shape
    if n > m:
        raise ValueError(f"{n} basins for {m} states")
    idx = [int(np.argmax(np.linalg.norm(X - X.mean(axis=0), axis=1)))]
    Y = X - X[idx[0]]
    for _ in range(1, n):
        norms = np.linalg.norm(Y, axis=1)
        v = int(np.argmax(norms))
        idx.append(v)
        d = Y[v] / max(norms[v], 1e-300)
        Y = Y - np.outer(Y @ d, d)
    chi = X @ np.linalg.pinv(X[idx])
    return chi, np.asarray(idx, dtype=np.int64)


class MergeSitesByMetastability(MergeSitesBase):
    """Merge sites into metastable kinetic basins via the slow spectrum
    of the measured jump chain.

    Parameters
    ----------
    n_basins : number of basins, or ``'auto'`` (default) — the count is
        chosen by **timescale separation**: the split point in the
        implied-timescale sequence ``t_k = -1/ln λ_k`` with the largest
        ratio ``t_{n-1} / t_n`` (kept basin-exchange modes vs merged-
        away intra-basin mixing), searched over the whole live
        spectrum.  On a *well-resolved* network every site is its own
        metastable state and the timescale sequence decays smoothly —
        no ratio clears ``min_separation`` and the merge is withheld.
        (A largest-*eigenvalue-gap* rule fails exactly there: on a
        slow-hopping lattice every coarse-graining has self-transition
        ≈ 1, so the gap lands on noise and merges real sites.)
    min_separation : with ``'auto'``, merge only if the best split's
        timescale ratio reaches this factor (default 5.0 — flicker
        between split pseudo-sites is typically orders of magnitude
        faster than real inter-site hopping).  Below it the analysis
        attributes are still filled in; the merge is withheld.  An
        explicit ``n_basins`` always merges.
    max_basins : optional upper bound on the automatic basin count
        (``None``, the default, searches the whole spectrum — an
        over-split 2N-site basis needs ``n = N``, so a small cap is
        wrong in the common case).
    min_timescale : with ``'auto'``, additionally require the slowest
        merged-away relaxation to live below this many frames — basins
        separated by slower processes are kept apart.  ``None`` (default)
        disables the extra requirement.
    distance_threshold : standard merge guard; ``None`` (default) since
        kinetic basins are routinely spatially extended.
    device : where :class:`JumpAnalysis` runs when the trajectory lacks
        jump statistics (default ``"cuda"``); the spectral work is host
        float64.

    After ``run``: ``eigenvalues_`` (descending, of the reversibilized
    chain, live states only), ``timescales_`` (``-1/ln λ`` in frames,
    for the eigenvalues in (0, 1)), ``separation_`` (the chosen
    split's timescale ratio; NaN when undefined), ``n_basins_``,
    ``labels_`` (per original site, ``-1`` for never-visited sites,
    which always stay singletons; when the merge is withheld before a
    basin diagnosis exists, live sites carry singleton labels
    ``0..m-1``), ``chi_`` (PCCA memberships, live sites × basins,
    columns aligned with the dense basin labels), and
    ``metastability_`` (mean self-transition
    probability of the coarse-grained chain — a diagnostic, not the
    acceptance criterion: on slow-hopping chains it is ≈ 1 for *any*
    partition).

    The actual merge honors the standard guards
    (:class:`~sitator_tpu_torch.network.merging.MergeSitesBase`): a guard can
    split a spectral basin into several merge groups.
    """

    def __init__(self, n_basins="auto", min_separation=5.0,
                 max_basins=None, min_timescale=None,
                 distance_threshold=None, check_types=True,
                 verbose=True, device="cuda"):
        super().__init__(distance_threshold=distance_threshold,
                         check_types=check_types, verbose=verbose)
        if n_basins != "auto":
            n_basins = int(n_basins)
            if n_basins < 2:
                raise ValueError("n_basins must be >= 2 (or 'auto')")
        self.n_basins = n_basins
        self.min_separation = float(min_separation)
        self.max_basins = None if max_basins is None else int(max_basins)
        self.min_timescale = (None if min_timescale is None
                              else float(min_timescale))
        self.device = device

    def _get_merges(self, st):
        sn = st.site_network
        if any(not sn.has_attribute(a)
               for a in ("n_ij", "total_corrected_residences")):
            JumpAnalysis(verbose=False, device=self.device).run(st)
        n_ij = np.asarray(sn.n_ij, dtype=np.float64).copy()
        np.fill_diagonal(n_ij, 0.0)
        t_i = np.asarray(sn.total_corrected_residences,
                         dtype=np.float64)
        S = sn.n_sites

        # pi-reversibilization of the empirical frame chain == the
        # symmetrized count matrix with residence self-loops
        C = 0.5 * (n_ij + n_ij.T)
        np.fill_diagonal(C, np.maximum(t_i - n_ij.sum(axis=1), 0.0))
        live = C.sum(axis=1) > 0
        self.labels_ = np.full(S, -1, dtype=np.int64)
        idx = np.flatnonzero(live)
        m = len(idx)
        self.eigenvalues_ = np.zeros(0)
        self.timescales_ = np.zeros(0)
        self.chi_ = None
        # withheld / degenerate paths must NOT leave live sites at -1
        # (the documented never-visited sentinel): default live sites
        # to singleton basins; a successful merge overwrites below
        self.labels_[idx] = np.arange(m)
        self.n_basins_ = m
        self.metastability_ = np.nan
        self.separation_ = np.nan
        if m < 2:
            return []

        Cl = C[np.ix_(idx, idx)]
        d = Cl.sum(axis=1)
        Dm = 1.0 / np.sqrt(d)
        lam, U = np.linalg.eigh(Dm[:, None] * Cl * Dm[None, :])
        order = np.argsort(lam)[::-1]
        lam, U = lam[order], U[:, order]
        self.eigenvalues_ = lam
        # implied timescales of every relaxation mode; eigenvalues at
        # or below 0 read as "instant", the Perron root is excluded
        lam_r = np.clip(lam[1:], 1e-12, 1.0 - 1e-15)
        T = -1.0 / np.log(lam_r)
        self.timescales_ = T

        # implied timescales below one frame are unresolvable at the
        # sampling resolution — two "instant" processes cannot carry a
        # meaningful ratio (on an iid chain, noise eigenvalues near 0
        # would otherwise fabricate huge sub-frame separations)
        Tf = np.maximum(T, 1.0)

        withheld = False
        if self.n_basins == "auto":
            # n basins keep relaxation modes 1..n-1 (basin exchange)
            # and merge away modes n.. (intra-basin mixing): choose the
            # split with the largest timescale separation
            hi = m - 1 if self.max_basins is None \
                else min(self.max_basins, m - 1)
            # degenerate unit eigenvalues beyond the Perron root are
            # disconnected chain components (e.g. a trapped ion that
            # never jumps) — structure, not kinetics.  A split whose
            # "kept/merged" boundary ratio involves a unit mode reads
            # as ~1e13x separation and would collapse the entire
            # connected network into one basin; restrict the search to
            # boundaries between genuine sub-unit relaxation modes
            # (every component mode is always kept: n >= k + 1 means
            # components can never be merged together)
            k = max(int(np.sum(lam >= 1.0 - 1e-10)), 1)
            if hi < k + 1:
                logger.info(
                    "auto metastability merge withheld: no sub-unit "
                    "split available (%d live sites, %d chain "
                    "component(s), max_basins=%s)", m, k,
                    self.max_basins)
                return []
            ratios = Tf[k - 1:hi - 1] / Tf[k:hi]
            n = int(np.argmax(ratios)) + k + 1
            if self.min_timescale is not None:
                # refuse to merge across processes slower than the floor
                while n <= hi and T[n - 1] > self.min_timescale:
                    n += 1
                if n > hi:
                    logger.info(
                        "auto metastability merge withheld: every "
                        "candidate split merges across a process "
                        "slower than min_timescale=%g frames",
                        self.min_timescale)
                    return []       # nothing mergeable below the floor
            self.separation_ = float(Tf[n - 2] / Tf[n - 1])
            if self.separation_ < self.min_separation:
                withheld = True
        else:
            n = min(self.n_basins, m)
            if 2 <= n <= m - 1:
                self.separation_ = float(T[n - 2]
                                         / max(T[n - 1], 1e-300))

        X = Dm[:, None] * U[:, :n]          # right eigvecs of Prev
        chi, _ = pcca_memberships(X)
        lab = np.argmax(chi, axis=1)
        # drop empty basins (pcca can leave one crisp-empty on
        # degenerate spectra) and renumber densely; keep chi_'s columns
        # aligned with the dense labels (argmax(chi_) == labels_[idx])
        uniq, lab = np.unique(lab, return_inverse=True)
        n = len(uniq)
        self.n_basins_ = n
        self.chi_ = chi[:, uniq]
        self.labels_[idx] = lab

        # coarse-grained metastability: chi-crisp aggregation of the
        # reversibilized chain
        agg = np.zeros((m, n))
        agg[np.arange(m), lab] = 1.0
        Pc = agg.T @ Cl @ agg
        rs = Pc.sum(axis=1, keepdims=True)
        Pc = np.where(rs > 0, Pc / rs, 0.0)
        self.metastability_ = float(np.trace(Pc)) / n
        if withheld:
            logger.warning(
                "auto metastability merge withheld: best timescale "
                "separation %.2fx < %.1fx — the chain has no clear "
                "fast/slow split, the network does not look over-"
                "split (pass n_basins explicitly to force a merge)",
                self.separation_, self.min_separation)
            return []
        if self.verbose:
            logger.info(
                "metastability: %d basins (of %d live sites), mean "
                "self-transition %.3f, slowest timescales %s frames",
                n, m, self.metastability_,
                np.array2string(self.timescales_[:max(n - 1, 1)],
                                precision=1))
        return [idx[lab == k] for k in range(n)]
