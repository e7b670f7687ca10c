"""Markovianity validation of the measured site chain.

Beyond the reference surface (upstream ``sitator`` never questions the
jump statistics it reports; SURVEY.md §3.4): every chain-consuming
engine in this package — :class:`~sitator_tpu_torch.dynamics.KineticMonteCarlo`,
:class:`~sitator_tpu_torch.dynamics.TransitionPathAnalysis`,
:func:`~sitator_tpu_torch.dynamics.mean_first_passage_times`,
:class:`~sitator_tpu_torch.dynamics.MergeSitesByMetastability` — assumes the
frame-resolution label sequence is Markovian *at the sites the
decomposition found*.  When sites alias distinct states (over-merged
basins, missed interstitials) that assumption fails quietly and every
downstream rate is wrong.  This module runs the two standard
Markov-state-model validation tests (Prinz et al., J. Chem. Phys. 134,
174105 (2011)):

- **implied timescales vs lag** — ``t_k(tau) = -tau / ln lambda_k(tau)``
  from the transition matrix estimated at lag ``tau``.  For a Markov
  chain these are lag-independent; for a lumped (hidden-state) chain
  the slow timescales climb with ``tau`` until the memory of the hidden
  structure decays.
- **Chapman–Kolmogorov** — ``P(k·tau)`` measured from the data must
  match ``P(tau)^k`` predicted from the base lag, compared on the
  metastable coarse sets (PCCA on the base-lag chain) where the
  statistics are strong.

Counting is one vectorized host pass over the label stream per lag
(the trajectory-scale device work already happened upstream — same
altitude as :mod:`sitator_tpu_torch.dynamics.balance`); the spectral work is
small dense ``eigh`` on the host.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitetraj import SiteTrajectory, forward_fill_labels
from sitator_tpu_torch.dynamics.metastable import pcca_memberships

__all__ = ["MarkovianityAnalysis", "lagged_count_matrix"]

logger = logging.getLogger(__name__)


def lagged_count_matrix(labels, lag, n_sites, raw_labels=None):
    """Transition count matrix ``C[i, j] = #{(t, ion): s_t = i,
    s_{t+lag} = j}`` over all sliding windows and ions.

    ``labels`` is ``(F, M)`` int with -1 for unknown; pairs with an
    unknown endpoint never count.  If ``raw_labels`` is given (the
    pre-fill label stream under the 'break' policy), pairs whose window
    spans *any* unknown frame are excluded too — a broken chain carries
    no information across the gap.
    """
    labels = np.asarray(labels)
    if lag <= 0 or lag >= len(labels):
        raise ValueError(f"lag {lag} outside (0, {len(labels)})")
    a, b = labels[:-lag], labels[lag:]
    ok = (a >= 0) & (b >= 0)
    if raw_labels is not None:
        unknown_count = np.cumsum(np.asarray(raw_labels) < 0, axis=0)
        ok &= unknown_count[:-lag] == unknown_count[lag:]
    idx = (a[ok].astype(np.int64) * n_sites + b[ok].astype(np.int64))
    return np.bincount(idx, minlength=n_sites * n_sites) \
        .reshape(n_sites, n_sites).astype(np.float64)


def _spectrum(C, k):
    """Top ``k+1`` eigenvalues (descending) of the reversibilized
    row-stochastic chain for count matrix ``C`` (live states only),
    via the symmetric normalized form.  Returns ``(eigenvalues,
    live_index, X)`` with ``X`` the right-eigenvector rows (for PCCA)."""
    live = np.flatnonzero(C.sum(axis=1) + C.sum(axis=0) > 0)
    Cl = C[np.ix_(live, live)]
    Cs = 0.5 * (Cl + Cl.T)
    d = Cs.sum(axis=1)
    d = np.where(d > 0, d, 1.0)
    Dm = 1.0 / np.sqrt(d)
    lam, U = np.linalg.eigh(Dm[:, None] * Cs * Dm[None, :])
    order = np.argsort(lam)[::-1][:k + 1]
    return lam[order], live, Dm[:, None] * U[:, order]


class MarkovianityAnalysis:
    """Validate the Markov assumption of the site label chain.

    Parameters
    ----------
    lags : frame lags at which to estimate the chain (default: powers
        of two ``1, 2, 4, ...`` capped at a quarter of the trajectory,
        at most 9 lags).  The first lag is the Chapman–Kolmogorov base.
    n_timescales : slow relaxation modes to track (default 5; clipped
        to the live-state count minus one).
    n_ck_sets : coarse sets for the Chapman–Kolmogorov comparison
        (default ``'auto'``: the number of slow modes above
        ``ck_set_timescale_floor`` frames at the base lag, between 2
        and 4 — per-site CK statistics are weak, metastable-set
        statistics are strong).  Sites grouped by PCCA on the base-lag
        chain.
    flatness_tol : relative drift of the slowest implied timescale
        across the lag range tolerated by ``markovian_`` (default 0.25).
    ck_tol : maximum |measured − predicted| set-residence probability
        tolerated by ``markovian_`` (default 0.05).
    unknown_policy : ``'persist'`` (default — forward-fill unknowns,
        the house convention) or ``'break'`` (windows spanning an
        unassigned frame are discarded).

    After ``run(st)`` (returns ``self``):

    - ``lags_`` — the lag grid actually used;
    - ``timescales_`` — ``(n_lags, K)`` implied timescales in frames
      (NaN where the mode has decayed below resolution);
    - ``eigenvalues_`` — ``(n_lags, K+1)`` leading eigenvalues;
    - ``timescale_drift_`` — per mode, ``t_k(lag_max) / t_k(lag_min) - 1``
      (≈ 0 for a Markov chain, systematically positive for lumped
      hidden states);
    - ``ck_lags_``, ``ck_measured_``, ``ck_predicted_``,
      ``ck_stderr_`` — ``(n_sets, n_ck_lags)`` set-residence
      probabilities, measured vs propagated, with the window-deflated
      binomial standard error of the measurement;
    - ``ck_error_`` — max absolute CK mismatch (NaN when the lag grid
      has no usable multiples of the base lag); ``ck_z_`` — max
      mismatch in stderr units; ``ck_violation_`` — some cell is both
      material (> ``ck_tol``) *and* significant (> 3 sigma);
    - ``sets_`` — per-site coarse-set labels (-1 for never-visited);
    - ``markovian_`` — both tests pass at this site resolution;
    - ``recommended_lag_`` — smallest lag whose slowest timescale is
      within ``flatness_tol`` of the longest-lag estimate (the lag at
      which a Markov model of these sites becomes usable), or ``None``.
    """

    def __init__(self, lags=None, n_timescales=5, n_ck_sets="auto",
                 flatness_tol=0.25, ck_tol=0.05,
                 ck_set_timescale_floor=2.0,
                 unknown_policy="persist", verbose=True):
        if lags is not None:
            lags = sorted({int(l) for l in lags})
            if not lags or lags[0] < 1:
                raise ValueError("lags must be positive integers")
        self.lags = lags
        self.n_timescales = int(n_timescales)
        if n_ck_sets != "auto" and int(n_ck_sets) < 2:
            raise ValueError("n_ck_sets must be >= 2 (or 'auto')")
        self.n_ck_sets = n_ck_sets
        self.flatness_tol = float(flatness_tol)
        self.ck_tol = float(ck_tol)
        self.ck_set_timescale_floor = float(ck_set_timescale_floor)
        if unknown_policy not in ("persist", "break"):
            raise ValueError("unknown_policy must be 'persist' or 'break'")
        self.unknown_policy = unknown_policy
        self.verbose = verbose

    # -- estimation ----------------------------------------------------
    def run(self, st):
        if isinstance(st, SiteTrajectory):
            raw = np.asarray(st.traj)
            S = st.site_network.n_sites
        else:                       # bare label array (F, M)
            raw = np.asarray(st)
            S = int(raw.max()) + 1
        F = len(raw)
        if self.unknown_policy == "persist":
            labels, raw_for_break = forward_fill_labels(raw), None
        else:
            labels, raw_for_break = raw, raw

        lags = self.lags
        if lags is None:
            lags, l = [], 1
            while l <= max(F // 4, 1) and len(lags) < 9:
                lags.append(l)
                l *= 2
        lags = [l for l in lags if l < F]
        if not lags:
            raise ValueError(f"no usable lag below n_frames={F}")
        self.lags_ = np.asarray(lags)

        counts = {l: lagged_count_matrix(labels, l, S, raw_for_break)
                  for l in lags}

        # -- implied timescales ---------------------------------------
        base = lags[0]
        lam0, live, X0 = _spectrum(counts[base], self.n_timescales)
        m = len(live)
        K = max(min(self.n_timescales, m - 1), 0)
        self.eigenvalues_ = np.full((len(lags), K + 1), np.nan)
        self.timescales_ = np.full((len(lags), K), np.nan)
        for i, l in enumerate(lags):
            lam, _, _ = _spectrum(counts[l], K)
            self.eigenvalues_[i, :len(lam)] = lam
            lam_r = lam[1:K + 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = -l / np.log(np.clip(lam_r, None, 1.0 - 1e-15))
            t[lam_r <= 0] = np.nan          # decayed below resolution
            self.timescales_[i, :len(t)] = t

        with np.errstate(invalid="ignore"):
            self.timescale_drift_ = (self.timescales_[-1]
                                     / self.timescales_[0]) - 1.0

        # -- Chapman–Kolmogorov on PCCA coarse sets -------------------
        self.sets_ = np.full(S, -1, dtype=np.int64)
        self.ck_lags_ = np.zeros(0, dtype=np.int64)
        self.ck_measured_ = self.ck_predicted_ = np.zeros((0, 0))
        self.ck_stderr_ = np.zeros((0, 0))
        self.ck_error_ = self.ck_z_ = np.nan
        self.ck_violation_ = False
        if m >= 2 and K >= 1:
            n_sets = self.n_ck_sets
            if n_sets == "auto":
                t0 = self.timescales_[0]
                slow = int(np.sum(np.nan_to_num(t0)
                                  > self.ck_set_timescale_floor))
                n_sets = min(max(slow + 1, 2), 4, m)
            else:
                n_sets = min(int(n_sets), m)
            n_sets = min(n_sets, X0.shape[1])
            chi, _ = pcca_memberships(X0[:, :n_sets])
            set_lab = np.argmax(chi, axis=1)
            uniq, set_lab = np.unique(set_lab, return_inverse=True)
            n_sets = len(uniq)
            self.sets_[live] = set_lab

            ck_lags = [l for l in lags if l % base == 0 and l > base]
            if ck_lags and n_sets >= 2:
                C0 = counts[base][np.ix_(live, live)]
                rs = C0.sum(axis=1, keepdims=True)
                P0 = np.where(rs > 0, C0 / np.maximum(rs, 1), 0.0)
                np.fill_diagonal(P0, P0.diagonal() + (rs[:, 0] == 0))
                pi = C0.sum(axis=1) + C0.sum(axis=0)
                pi = pi / pi.sum()
                A = np.zeros((m, n_sets))
                A[np.arange(m), set_lab] = 1.0
                wA = pi[:, None] * A                  # (m, n_sets)
                wA_sum = np.maximum(wA.sum(axis=0), 1e-300)

                meas = np.full((n_sets, len(ck_lags)), np.nan)
                pred = np.full((n_sets, len(ck_lags)), np.nan)
                serr = np.full((n_sets, len(ck_lags)), np.nan)
                Pk = P0.copy()
                k_done = 1
                for j, l in enumerate(ck_lags):
                    Cl = counts[l][np.ix_(live, live)]
                    rsl = Cl.sum(axis=1, keepdims=True)
                    Pl = np.where(rsl > 0, Cl / np.maximum(rsl, 1), 0.0)
                    np.fill_diagonal(Pl,
                                     Pl.diagonal() + (rsl[:, 0] == 0))
                    k = l // base
                    while k_done < k:
                        Pk = Pk @ P0
                        k_done += 1
                    meas[:, j] = (wA.T @ Pl @ A).diagonal() / wA_sum
                    pred[:, j] = (wA.T @ Pk @ A).diagonal() / wA_sum
                    # binomial stderr of the measured residence prob;
                    # windows overlap (slide by 1, span l frames), so
                    # the independent-sample count is deflated by l
                    n_A = (A.T @ Cl.sum(axis=1)) / l
                    p = np.clip(0.5 * (meas[:, j] + pred[:, j]),
                                1e-6, 1 - 1e-6)
                    serr[:, j] = np.sqrt(p * (1 - p)
                                         / np.maximum(n_A, 1.0))
                self.ck_lags_ = np.asarray(ck_lags)
                self.ck_measured_, self.ck_predicted_ = meas, pred
                self.ck_stderr_ = serr
                diff = np.abs(meas - pred)
                self.ck_error_ = float(np.nanmax(diff))
                with np.errstate(invalid="ignore"):
                    self.ck_z_ = float(np.nanmax(diff / serr))
                # a violating cell is both material and significant
                self.ck_violation_ = bool(np.any(
                    (diff > self.ck_tol) & (diff > 3.0 * serr)))

        # -- verdicts --------------------------------------------------
        drift0 = (abs(self.timescale_drift_[0])
                  if K >= 1 and np.isfinite(self.timescale_drift_[0])
                  else 0.0)
        # a CK violation must be both material (> ck_tol) and
        # statistically significant (> 3 sigma of the window-deflated
        # binomial error) — on short trajectories the long-lag cells
        # are noise and must not condemn a sound site model
        self.markovian_ = bool(drift0 <= self.flatness_tol
                               and not self.ck_violation_)

        self.recommended_lag_ = None
        if K >= 1:
            t_end = self.timescales_[-1, 0]
            if np.isfinite(t_end) and t_end > 0:
                for i, l in enumerate(lags):
                    t = self.timescales_[i, 0]
                    if np.isfinite(t) and \
                            abs(t / t_end - 1.0) <= self.flatness_tol:
                        self.recommended_lag_ = int(l)
                        break

        if self.verbose:
            logger.info(
                "markovianity: slowest timescale %s -> %s frames over "
                "lags %d..%d (drift %+.0f%%), CK error %s -> %s",
                _fmt(self.timescales_[0, 0] if K else np.nan),
                _fmt(self.timescales_[-1, 0] if K else np.nan),
                lags[0], lags[-1], 100 * drift0,
                _fmt(self.ck_error_),
                "MARKOVIAN at this site resolution" if self.markovian_
                else "NON-MARKOVIAN — sites are aliasing hidden states "
                     "(or use a longer lag; see recommended_lag_)")
        return self


def _fmt(x):
    return f"{x:.3g}" if np.isfinite(x) else "n/a"
