"""Diffusivity analyses — tracer / collective D, Haven ratio, and a
site-hop diffusivity cross-check.

Beyond-reference kinetics: upstream ``sitator`` stops at jump statistics
(SURVEY.md §3.4) and its users compute diffusivities by hand around it.
Here they are first-class engines following the same
``Engine(params).run(input)`` convention, with the O(F log F) MSD in host
float64 (:mod:`sitator_tpu_torch.ops.msd`).

- :class:`DiffusionAnalysis` — from the real MD trajectory: unwraps the
  mobile ions, computes the time-origin-averaged MSD by FFT, fits the
  tracer diffusivity (with a per-atom jackknife error), the collective
  (charge) diffusivity, the Haven ratio, and — given a temperature — the
  Nernst–Einstein ionic conductivity.
- :class:`SiteDiffusionAnalysis` — the same estimator applied to the
  *discretized* trajectory (each ion at its assigned site center,
  unknowns forward-filled): how much of the kinetics the site
  description captures.  ``D_site / D_tracer`` near 1 validates the site
  decomposition; a shortfall quantifies intra-site (vibrational) motion
  excluded by the discretization.

Units: results are in (length²/time) of whatever units the trajectory
and ``timestep`` are in.  ``conductivity_`` assumes Å, ps, elementary
charges and kelvin, and is returned in S/cm.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.ops import msd as msd_ops

__all__ = ["DiffusionAnalysis", "SiteDiffusionAnalysis",
           "RelaxationAnalysis"]

logger = logging.getLogger(__name__)

_E_CHARGE = 1.602176634e-19      # C
_K_B = 1.380649e-23              # J/K


def _check_fit_range(fit_range):
    lo, hi = fit_range
    if not (0.0 <= lo < hi <= 1.0):
        raise ValueError("fit_range must satisfy 0 <= lo < hi <= 1")
    return (float(lo), float(hi))


def _apply_drift_correction(unwrapped, traj, mobile_mask, cell, spec,
                            exact):
    """Shift ``unwrapped`` (F, M, 3) into the mean frame of the
    reference group named by ``spec``: ``'static'`` (all non-mobile
    atoms — the host lattice), ``'all'``, or a boolean ``(n_atoms,)``
    mask over the full trajectory.  Returns ``(corrected, drift)``
    with ``drift`` the (F, 3) subtracted curve (``None`` when
    ``spec`` is None)."""
    if spec is None:
        return unwrapped, None
    if isinstance(spec, str):
        if spec == "all":
            mask = None
        elif spec == "static":
            mask = ~np.asarray(mobile_mask, dtype=bool)
            if not mask.any():
                raise ValueError("drift_correction='static': every atom "
                                 "is mobile — no host frame to pin to")
        else:
            raise ValueError(f"unknown drift_correction {spec!r} "
                             "(use 'static', 'all', or a boolean mask)")
    else:
        mask = spec
    drift = msd_ops.drift_curve(traj, cell, mask, exact=exact)
    return unwrapped - drift[:, None, :], drift


def _per_signal_slopes(times, curves, lo, hi):
    """Least-squares slopes of each row of ``curves`` over ``times[lo:hi]``
    (vectorized normal equations — one pass, no per-row solve)."""
    t = times[lo:hi]
    y = curves[:, lo:hi]
    t_c = t - t.mean()
    denom = float((t_c * t_c).sum())
    return (y - y.mean(axis=1, keepdims=True)) @ t_c / denom


class DiffusionAnalysis:
    """Tracer + collective diffusivity from a real trajectory.

    Parameters
    ----------
    timestep : time between stored frames.
    fit_range : (lo, hi) fractions of the maximum lag over which the MSD
        is fitted (default (0.2, 0.5) — past the ballistic/vibrational
        knee, before the noisy long-lag tail).
    temperature : optional, kelvin — enables ``conductivity_`` (assumes
        Å / ps / elementary charges).
    charge : mobile-ion charge in elementary charges (for conductivity).
    exact_unwrap : use the exact 27-image minimum-image displacement for
        unwrapping (very skewed triclinic cells).
    drift_correction : ``None`` (default — lab frame), ``'static'``
        (subtract the mean displacement of the non-mobile atoms: the
        host-lattice frame), ``'all'``, or a boolean ``(n_atoms,)``
        mask.  Thermostat / barostat / host drift enters the MSD as a
        spurious ``(v·t)²`` term that inflates the fitted D; pinning
        to the host frame is standard practice for solid electrolytes.
        The subtracted curve lands in ``drift_`` ((F, 3), or None).

    After ``run``: ``times_`` (F,), ``msd_`` (F,), ``msd_per_atom_``
    (M, F), ``D_tracer_``, ``D_tracer_err_`` (jackknife standard error
    over atoms), ``D_collective_`` (per ion), ``haven_ratio_``
    (= D_tracer / D_collective), ``conductivity_`` (S/cm or None).
    ``run`` returns ``self``.

    Equilibration / stationarity diagnostics (computed always):
    ``msd_exponent_`` — the log-log slope of the MSD over the fit
    window (≈1 for diffusive motion; ≫1 flags ballistic or drift
    contamination, ≪1 subdiffusive/caged dynamics — in either case the
    fitted D is not a diffusivity), and ``stationarity_ratio_`` — the
    tracer D of the second half of the trajectory over the first
    (≈1 when stationary; far from 1 flags an unequilibrated or aging
    run, NaN when either half-window slope is non-positive).

    Anisotropy (layered / 1-D-channel conductors): ``msd_tensor_``
    (F, 3, 3) displacement-covariance curves, ``D_tensor_`` (3, 3)
    fitted over the same lag window (``trace(D_tensor_)/3 ==
    D_tracer_`` up to fit noise — same estimator), ``D_eigvals_`` /
    ``D_eigvecs_`` (ascending, from ``eigh``: the principal transport
    axes), and ``anisotropy_`` = λ_max/λ_min (1 for isotropic motion;
    NaN when λ_min ≤ 0, i.e. a direction shows no diffusive signal).
    """

    def __init__(self, timestep=1.0, fit_range=(0.2, 0.5),
                 temperature=None, charge=1.0, exact_unwrap=False,
                 drift_correction=None, verbose=True):
        self.timestep = float(timestep)
        self.fit_range = _check_fit_range(fit_range)
        self.temperature = temperature
        self.charge = float(charge)
        self.exact_unwrap = bool(exact_unwrap)
        self.drift_correction = drift_correction
        self.verbose = verbose

    # -- input plumbing ----------------------------------------------
    @staticmethod
    def _coerce(st_or_traj, mobile_mask, cell):
        if hasattr(st_or_traj, "real_trajectory"):
            st = st_or_traj
            traj = st.real_trajectory
            if traj is None:
                raise ValueError(
                    "SiteTrajectory has no real trajectory (set_real_traj)")
            sn = st.site_network
            return np.asarray(traj), sn.mobile_mask, sn.structure.cell
        traj = np.asarray(st_or_traj)
        if mobile_mask is None or cell is None:
            raise ValueError("raw trajectory needs mobile_mask and cell")
        return traj, np.asarray(mobile_mask), np.asarray(cell)

    # -- the analysis ------------------------------------------------
    def run(self, st_or_traj, mobile_mask=None, cell=None):
        traj, mobile_mask, cell = self._coerce(st_or_traj, mobile_mask,
                                               cell)
        pos = traj[:, mobile_mask, :]
        F, M = pos.shape[:2]
        if F < 8:
            raise ValueError(f"need at least 8 frames, got {F}")

        unwrapped = msd_ops.unwrap_trajectory(pos, cell,
                                              exact=self.exact_unwrap)
        unwrapped, self.drift_ = _apply_drift_correction(
            unwrapped, traj, mobile_mask, cell, self.drift_correction,
            self.exact_unwrap)
        # one FFT pass yields the covariance tensor AND the scalar
        # curves (trace); msd_fft would duplicate the diagonal work
        self.msd_tensor_, per_atom = msd_ops.msd_tensor_fft(
            unwrapped, per_atom_trace=True)
        coll = msd_ops.collective_msd_fft(unwrapped)
        self.msd_ = np.trace(self.msd_tensor_, axis1=1, axis2=2)
        self.msd_per_atom_ = np.asarray(per_atom, dtype=np.float64)
        coll = np.asarray(coll, dtype=np.float64) / M   # per ion
        self.times_ = np.arange(F, dtype=np.float64) * self.timestep

        lo, hi = msd_ops.fit_window(F, self.fit_range)
        self.D_tracer_, _ = msd_ops.fit_diffusivity(
            self.times_, self.msd_, self.fit_range)
        self.D_collective_, _ = msd_ops.fit_diffusivity(
            self.times_, coll, self.fit_range)
        self.msd_collective_ = coll

        # jackknife over atoms: SE of the slope-derived tracer D
        slopes = _per_signal_slopes(self.times_, self.msd_per_atom_,
                                    lo, hi) / 6.0
        if M > 1:
            jk = (slopes.sum() - slopes) / (M - 1)     # leave-one-out means
            self.D_tracer_err_ = float(
                np.sqrt((M - 1) / M * ((jk - jk.mean()) ** 2).sum()))
        else:
            self.D_tracer_err_ = float("nan")
        self.D_per_atom_ = slopes

        self.haven_ratio_ = (
            float(self.D_tracer_ / self.D_collective_)
            if self.D_collective_ > 0 else float("nan"))

        # equilibration / stationarity diagnostics
        self.msd_exponent_ = self._loglog_slope(
            self.times_[lo:hi], self.msd_[lo:hi])
        self.stationarity_ratio_ = self._split_half_ratio(unwrapped)

        # anisotropy: per-component-pair slopes over the SAME window;
        # each component is 1-D, so D_ab = slope_ab / 2
        D_t = np.empty((3, 3))
        for a in range(3):
            for b in range(a, 3):
                D_ab, _ = msd_ops.fit_diffusivity(
                    self.times_, self.msd_tensor_[:, a, b],
                    self.fit_range, dim=1)
                D_t[a, b] = D_t[b, a] = D_ab
        self.D_tensor_ = D_t
        self.D_eigvals_, self.D_eigvecs_ = np.linalg.eigh(D_t)
        lo_ev, hi_ev = self.D_eigvals_[0], self.D_eigvals_[-1]
        self.anisotropy_ = (float(hi_ev / lo_ev) if lo_ev > 0
                            else float("nan"))

        if self.verbose and not (0.8 <= self.msd_exponent_ <= 1.2):
            logger.warning(
                "MSD exponent over the fit window is %.2f (diffusive "
                "motion gives ~1) — the fitted D is suspect; check "
                "equilibration, drift (drift_correction=), or move "
                "fit_range past the ballistic/caged knee",
                self.msd_exponent_)

        self.conductivity_ = None
        if self.temperature is not None:
            if self.D_collective_ > 0:
                # Å²/ps → m²/s is 1e-8; V in Å³ → m³ is 1e-30; S/m → S/cm
                vol_m3 = float(abs(np.linalg.det(cell))) * 1e-30
                d_m2s = self.D_collective_ * 1e-8
                sigma_sm = (M * (self.charge * _E_CHARGE) ** 2 * d_m2s
                            / (vol_m3 * _K_B * float(self.temperature)))
                self.conductivity_ = sigma_sm / 100.0
            else:
                # a noise-negative collective slope (few ions / short
                # runs) has no physical conductivity — don't report one
                self.conductivity_ = float("nan")
                logger.warning(
                    "collective MSD slope is non-positive (%.3g) — "
                    "conductivity_ set to NaN; more frames or ions "
                    "needed for a collective estimate",
                    self.D_collective_)
        if self.verbose:
            logger.info(
                "D_tracer = %.4g ± %.2g, D_collective = %.4g, H_R = %.3g",
                self.D_tracer_, self.D_tracer_err_, self.D_collective_,
                self.haven_ratio_)
        return self

    @staticmethod
    def _loglog_slope(t, y):
        """Least-squares slope of log y vs log t (NaN when fewer than
        two strictly positive points survive)."""
        ok = (t > 0) & (y > 0)
        if ok.sum() < 2:
            return float("nan")
        lt, ly = np.log(t[ok]), np.log(y[ok])
        lt_c = lt - lt.mean()
        return float((ly - ly.mean()) @ lt_c / (lt_c @ lt_c))

    def _split_half_ratio(self, unwrapped):
        """Tracer D of the second half over the first, both fitted over
        the same fractional lag window (each half re-unwraps nothing:
        the input is already continuous)."""
        F = unwrapped.shape[0]
        half = F // 2
        if half < 8:
            return float("nan")
        Ds = []
        for seg in (unwrapped[:half], unwrapped[F - half:]):
            msd, _ = msd_ops.msd_fft(seg)
            times = np.arange(half, dtype=np.float64) * self.timestep
            D, _ = msd_ops.fit_diffusivity(times, np.asarray(msd),
                                           self.fit_range)
            Ds.append(D)
        if Ds[0] <= 0 or Ds[1] <= 0:
            return float("nan")
        return float(Ds[1] / Ds[0])


class SiteDiffusionAnalysis:
    """Diffusivity of the *site-discretized* trajectory.

    Each ion is placed at its assigned site center (unassigned frames
    forward-filled from the last known site; leading unknowns
    back-filled), the resulting center path is unwrapped minimum-image,
    and the same FFT-MSD estimator is fitted.  After ``run(st)``:
    ``times_``, ``msd_``, ``D_site_``; returns ``self``.

    When the network carries JumpAnalysis attributes (``n_ij``,
    ``total_corrected_residences``), also computes the **uncorrelated
    jump-diffusion estimate** ``D_jump_ = Σ n_ij·|ℓ_ij|² / (6·M·T)``
    (``ℓ_ij`` = minimum-image center separation, ``T`` the trajectory
    time span) and the **correlation factor** ``f_ = D_site_/D_jump_``
    — the standard measure of hop-sequence correlation in solid
    electrolytes: ``f ≈ 1`` for uncorrelated (random-walk) hopping,
    ``f < 1`` for back-correlated motion (e.g. flickering between two
    sites gives ``f → 0``).  Both are NaN when the attributes are
    absent or no jumps were recorded.

    Independently of JumpAnalysis attributes, the **jump-vector
    directional correlation** is computed straight from the label
    stream: ``cos_theta_`` is the mean cosine between consecutive
    minimum-image jump vectors of the same ion (over
    ``n_jump_vector_pairs_`` pairs) and ``f_angular_ =
    (1 + ⟨cosθ⟩)/(1 − ⟨cosθ⟩)`` — the sequential-correlation-walk
    correlation factor, exact when all jumps have equal length (cubic
    site lattices; an approximation otherwise).  ``f_angular_ ≈ f_``
    is a strong consistency check; flicker drives both to 0.  NaN when
    no ion makes two jumps.
    """

    def __init__(self, timestep=1.0, fit_range=(0.2, 0.5), verbose=True):
        self.timestep = float(timestep)
        self.fit_range = _check_fit_range(fit_range)
        self.verbose = verbose

    @staticmethod
    def _filled_labels(labels):
        """Forward-fill -1 labels; leading unknowns take the first known
        site (an ion never assigned anywhere raises)."""
        from sitator_tpu_torch.core.sitetraj import forward_fill_labels
        return forward_fill_labels(labels, leading="first")

    def run(self, st):
        sn = st.site_network
        if sn.centers is None:
            raise ValueError("site network has no centers")
        labels = self._filled_labels(st.traj)
        pos = np.asarray(sn.centers)[labels]           # (F, M, 3)
        unwrapped = msd_ops.unwrap_trajectory(pos, sn.structure.cell)
        mean_msd, _ = msd_ops.msd_fft(unwrapped)
        self.msd_ = np.asarray(mean_msd, dtype=np.float64)
        F = len(self.msd_)
        self.times_ = np.arange(F, dtype=np.float64) * self.timestep
        self.D_site_, _ = msd_ops.fit_diffusivity(
            self.times_, self.msd_, self.fit_range)
        self.D_jump_, self.f_ = self._jump_diffusivity(sn, st)
        (self.cos_theta_, self.f_angular_,
         self.n_jump_vector_pairs_) = self._jump_vector_correlation(
            sn, labels)
        if self.verbose:
            logger.info("D_site = %.4g (D_jump = %.4g, f = %.3g, "
                        "f_angular = %.3g over %d jump pairs)",
                        self.D_site_, self.D_jump_, self.f_,
                        self.f_angular_, self.n_jump_vector_pairs_)
        return self

    @staticmethod
    def _jump_vector_correlation(sn, labels):
        """Mean cosine between consecutive minimum-image jump vectors
        per ion, and the sequential-correlation-walk factor
        ``(1+c)/(1-c)`` (clamped to 0 at c <= -1; NaN with < 1 pair)."""
        centers = np.asarray(sn.centers, dtype=np.float64)
        cell = np.asarray(sn.structure.cell, dtype=np.float64)
        inv = np.linalg.inv(cell)
        cos_sum, n_pairs = 0.0, 0
        for m in range(labels.shape[1]):
            seq = labels[:, m]
            keep = np.concatenate([[True], seq[1:] != seq[:-1]])
            sites = seq[keep]
            if len(sites) < 3:            # < 2 jumps -> no pair
                continue
            d = centers[sites[1:]] - centers[sites[:-1]]
            frac = d @ inv
            d = (frac - np.round(frac)) @ cell
            norms = np.linalg.norm(d, axis=1)
            u = d / np.maximum(norms, 1e-300)[:, None]
            c = (u[1:] * u[:-1]).sum(1)
            ok = (norms[1:] > 0) & (norms[:-1] > 0)
            cos_sum += float(c[ok].sum())
            n_pairs += int(ok.sum())
        if n_pairs == 0:
            return float("nan"), float("nan"), 0
        c = cos_sum / n_pairs
        f_ang = (1.0 + c) / (1.0 - c) if c < 1.0 else float("inf")
        return float(c), float(max(f_ang, 0.0)), n_pairs

    def _jump_diffusivity(self, sn, st):
        """Uncorrelated jump-diffusion estimate and correlation factor
        from the network's JumpAnalysis attributes (NaN when absent)."""
        if not (sn.has_attribute("n_ij")
                and sn.has_attribute("total_corrected_residences")):
            return float("nan"), float("nan")
        from sitator_tpu_torch.network.compare import min_image_distance_matrix
        n_ij = np.asarray(sn.n_ij, dtype=np.float64).copy()
        np.fill_diagonal(n_ij, 0.0)
        centers = np.asarray(sn.centers, dtype=np.float64)
        cell = np.asarray(sn.structure.cell, dtype=np.float64)
        l2 = min_image_distance_matrix(centers, centers, cell) ** 2
        T = (st.n_frames - 1) * self.timestep
        M = st.n_mobile
        if T <= 0 or n_ij.sum() == 0:
            return float("nan"), float("nan")
        D_jump = float((n_ij * l2).sum() / (6.0 * M * T))
        f = self.D_site_ / D_jump if D_jump > 0 else float("nan")
        return D_jump, float(f)


class RelaxationAnalysis:
    """Dynamic-heterogeneity / relaxation observables of the mobile ions:
    the non-Gaussian parameter α₂(t) and the (isotropically exact)
    self-intermediate scattering function F_s(q, t).

    Parameters
    ----------
    q : wavevector magnitude for F_s (same inverse-length unit as the
        trajectory; a natural choice is 2π over the jump length).
    lags : frame lags to evaluate (default: ~24 log-spaced lags up to
        half the trajectory).
    timestep, origin_stride : as elsewhere.
    drift_correction : as in :class:`DiffusionAnalysis` — long-lag
        α₂/F_s are especially drift-sensitive.

    After ``run``: ``lags_``, ``times_``, ``msd_lags_``, ``alpha2_``,
    ``fs_``, and ``tau_alpha_`` — the relaxation time where F_s first
    crosses 1/e (linearly interpolated; NaN when it never does).
    ``run`` accepts a SiteTrajectory with a real trajectory attached or
    a raw array plus ``mobile_mask``/``cell``; returns ``self``.
    """

    def __init__(self, q, lags=None, timestep=1.0, origin_stride=1,
                 exact_unwrap=False, drift_correction=None, verbose=True):
        self.q = float(q)
        if self.q <= 0:
            raise ValueError("q must be positive")
        self.lags = lags
        self.timestep = float(timestep)
        self.origin_stride = int(origin_stride)
        self.exact_unwrap = bool(exact_unwrap)
        self.drift_correction = drift_correction
        self.verbose = verbose

    @staticmethod
    def _default_lags(n_frames, n=24):
        # largest usable lag: half the trajectory, but never past F-1
        # (a 2-frame trajectory has exactly one nonzero lag)
        hi = min(max(1, n_frames // 2), n_frames - 1)
        grid = np.unique(np.round(np.logspace(
            0, np.log10(hi), n)).astype(np.int64))
        return np.concatenate([[0], grid])

    def run(self, st_or_traj, mobile_mask=None, cell=None):
        traj, mobile_mask, cell = DiffusionAnalysis._coerce(
            st_or_traj, mobile_mask, cell)
        pos = msd_ops.unwrap_trajectory(traj[:, mobile_mask, :], cell,
                                        exact=self.exact_unwrap)
        pos, self.drift_ = _apply_drift_correction(
            pos, traj, mobile_mask, cell, self.drift_correction,
            self.exact_unwrap)
        F = pos.shape[0]
        if F < 2:
            raise ValueError(
                f"RelaxationAnalysis needs at least 2 frames, got {F}")
        lags = (self._default_lags(F) if self.lags is None
                else np.asarray([int(l) for l in self.lags]))
        self.lags_ = lags
        self.times_ = lags * self.timestep
        # one pass over the per-lag |Δr| arrays serves both the moments
        # and F_s (they dominate the host cost on long trajectories)
        self.msd_lags_, _, self.alpha2_, self.fs_ = msd_ops.lag_statistics(
            pos, lags, origin_stride=self.origin_stride, q=self.q)
        self.tau_alpha_ = self._crossing_time(self.times_, self.fs_,
                                              1.0 / np.e)
        if self.verbose:
            logger.info("alpha2 peak %.3g at t = %.4g; tau_alpha = %.4g",
                        self.alpha2_.max(),
                        self.times_[int(np.argmax(self.alpha2_))],
                        self.tau_alpha_)
        return self

    @staticmethod
    def _crossing_time(times, values, level):
        """First downward crossing of ``level``, linearly interpolated."""
        below = np.where(values < level)[0]
        if len(below) == 0:
            return float("nan")
        j = below[0]
        if j == 0:
            return float(times[0])
        t0, t1 = times[j - 1], times[j]
        v0, v1 = values[j - 1], values[j]
        if v0 == v1:
            return float(t1)
        return float(t0 + (v0 - level) / (v0 - v1) * (t1 - t0))
