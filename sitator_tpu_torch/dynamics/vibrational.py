"""Vibrational observables of the mobile ions.

- :class:`AverageVibrationalFrequency` — attempt-frequency estimate
  (reference parity: ``sitator/dynamics/AverageVibrationalFrequency``,
  SURVEY.md §3.4 ⚠ low-confidence component): the spectrally-averaged
  vibrational frequency, used to normalize jump rates into attempt
  frequencies.  Power-spectrum-weighted mean frequency of the
  mobile-ion velocity signal (FFT of minimum-image frame-difference
  velocities).
- :class:`VibrationalSpectrumAnalysis` (beyond the reference surface) —
  the full velocity autocorrelation function, the vibrational density
  of states, and the Green–Kubo diffusivity, from the same
  frame-difference velocities.
- :class:`ConductivitySpectrumAnalysis` (beyond the reference surface) —
  the frequency-dependent ionic conductivity σ(ω) from the
  charge-current autocorrelation (the Green–Kubo route; the quantity
  impedance spectroscopy measures), whose ω→0 limit is the Onsager /
  collective-diffusion DC conductivity.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.dynamics.diffusion import _E_CHARGE, _K_B
from sitator_tpu_torch.ops.pbc import PBCCalculator

logger = logging.getLogger(__name__)


def _frame_diff_velocities(st_or_traj, mobile_mask, cell, timestep,
                           min_frames=3):
    """Shared input handling: minimum-image frame-difference velocities
    ``(F-1, M, 3)`` float64 of the mobile ions."""
    if hasattr(st_or_traj, "real_trajectory"):
        st = st_or_traj
        traj = st.real_trajectory
        if traj is None:
            raise ValueError("SiteTrajectory has no real trajectory")
        sn = st.site_network
        mobile_mask = sn.mobile_mask
        cell = sn.structure.cell
    else:
        traj = np.asarray(st_or_traj)
        if mobile_mask is None or cell is None:
            raise ValueError("raw trajectory needs mobile_mask and cell")
    if traj.shape[0] < min_frames:
        raise ValueError(f"need at least {min_frames} frames")
    calc = PBCCalculator(cell)
    pos = traj[:, np.asarray(mobile_mask, dtype=bool), :].astype(
        np.float64)
    disp = (pos[1:] - pos[:-1]).reshape(-1, 3)
    disp = np.asarray(calc._min_image_disp(disp)).reshape(
        len(pos) - 1, -1, 3)
    return disp / float(timestep)


class AverageVibrationalFrequency:
    """Parameters
    ----------
    timestep : MD timestep between stored frames (any time unit; the result
        is in cycles per that unit).
    freq_cut : optional (lo, hi) band (same units) to integrate over.
    """

    def __init__(self, timestep=1.0, freq_cut=None, verbose=True):
        self.timestep = float(timestep)
        self.freq_cut = freq_cut
        self.verbose = verbose

    def run(self, st_or_traj, mobile_mask=None, cell=None):
        """Accepts a SiteTrajectory with a real trajectory attached, or a raw
        ``(n_frames, n_atoms, 3)`` array plus ``mobile_mask``/``cell``.
        Returns the average vibrational frequency (float).  When given a
        SiteTrajectory, also writes site attribute-independent scalar onto
        ``site_network`` as ``avg_vibrational_freq`` metadata."""
        st = (st_or_traj if hasattr(st_or_traj, "real_trajectory")
              else None)
        v = _frame_diff_velocities(st_or_traj, mobile_mask, cell,
                                   self.timestep, min_frames=2)

        spec = np.abs(np.fft.rfft(v - v.mean(0), axis=0)) ** 2
        power = spec.sum(axis=(1, 2))                 # (F//2+1,)
        freqs = np.fft.rfftfreq(v.shape[0], d=self.timestep)
        sel = freqs > 0
        if self.freq_cut is not None:
            lo, hi = self.freq_cut
            sel &= (freqs >= lo) & (freqs <= hi)
        p = power[sel]
        f = freqs[sel]
        if p.sum() == 0:
            return 0.0
        nu = float((f * p).sum() / p.sum())
        if st is not None:
            # scalar metadata: store as a per-site constant attribute so it
            # survives subsetting/merging like any other result
            sn = st.site_network
            if "avg_vibrational_freq" in sn.site_attributes:
                sn.remove_attribute("avg_vibrational_freq")
            sn.add_site_attribute(
                "avg_vibrational_freq", np.full(sn.n_sites, nu))
        return nu


class VibrationalSpectrumAnalysis:
    """VACF, vibrational density of states, and Green–Kubo diffusivity
    of the mobile ions (beyond the reference surface — the short-time /
    spectral complement of the MSD route in
    :class:`~sitator_tpu_torch.dynamics.diffusion.DiffusionAnalysis`).

    Velocities are minimum-image frame differences (no stored
    velocities needed).  After ``run(st)`` (or a raw trajectory plus
    ``mobile_mask``/``cell``):

    - ``times_``, ``vacf_``: the all-origins velocity autocorrelation
      Z(t) (``vacf_[0]`` = mean squared speed) and ``psi_`` = Z/Z(0);
    - ``freqs_``, ``vdos_``: the vibrational density of states — the
      atom/component-summed velocity power spectrum (Wiener–Khinchin
      pair of the VACF, positive by construction), normalized to
      integrate to 1 over frequency (cycles per time unit);
    - ``D_gk_running_``: the running Green–Kubo integral
      (1/3)∫₀ᵗ Z dt' (trapezoid), and ``D_gk_`` — its mean over the
      ``integral_window`` fraction of the lag axis.  For
      frame-difference velocities of a jump process this matches the
      MSD diffusivity in expectation (tested against
      :class:`~sitator_tpu_torch.dynamics.diffusion.DiffusionAnalysis`);
      for bound (oscillatory) motion it averages to ~0.

    GK plateau caveat: the running integral only plateaus once the VACF
    has decayed; ``integral_window`` defaults to (0.1, 0.5) of the lag
    axis — inspect ``D_gk_running_`` when in doubt (long-lag origins
    are noisy, which is why the window stops at half).
    """

    def __init__(self, timestep=1.0, max_lag=None,
                 integral_window=(0.1, 0.5), verbose=True):
        self.timestep = float(timestep)
        self.max_lag = max_lag
        lo, hi = (float(integral_window[0]), float(integral_window[1]))
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError("integral_window must satisfy "
                             "0 <= lo < hi <= 1")
        self.integral_window = (lo, hi)
        self.verbose = verbose

    def run(self, st_or_traj, mobile_mask=None, cell=None):
        from sitator_tpu_torch.ops import msd as msd_ops
        v = _frame_diff_velocities(st_or_traj, mobile_mask, cell,
                                   self.timestep)
        n_lags = v.shape[0]
        if self.max_lag is not None:
            n_lags = min(n_lags, int(self.max_lag) + 1)
        Z, _ = msd_ops.vacf_fft(v)
        self.vacf_ = Z[:n_lags]
        self.psi_ = (self.vacf_ / self.vacf_[0] if self.vacf_[0] > 0
                     else np.full_like(self.vacf_, np.nan))
        self.times_ = np.arange(n_lags, dtype=np.float64) * self.timestep

        # VDOS: periodogram of the velocity signal (positive, equals
        # the cosine transform of the VACF in expectation)
        spec = (np.abs(np.fft.rfft(v, axis=0)) ** 2).sum(axis=(1, 2))
        self.freqs_ = np.fft.rfftfreq(v.shape[0], d=self.timestep)
        df = (self.freqs_[1] if len(self.freqs_) > 1 else 1.0)
        norm = spec.sum() * df
        self.vdos_ = spec / norm if norm > 0 else spec

        # Green–Kubo running integral, D(t) = (1/3) int_0^t Z
        incr = 0.5 * (self.vacf_[1:] + self.vacf_[:-1]) * self.timestep
        self.D_gk_running_ = np.concatenate(
            [[0.0], np.cumsum(incr)]) / 3.0
        lo = int(round(self.integral_window[0] * (n_lags - 1)))
        hi = max(lo + 1, int(round(self.integral_window[1] * (n_lags - 1))))
        self.D_gk_ = float(self.D_gk_running_[lo:hi + 1].mean())
        if self.verbose:
            peak = float(self.freqs_[int(np.argmax(self.vdos_))])
            logger.info("VACF/VDOS: peak at %.4g cycles/time, "
                        "D_GK = %.4g", peak, self.D_gk_)
        return self


class ConductivitySpectrumAnalysis:
    """Frequency-dependent ionic conductivity σ(ω) from the
    charge-current autocorrelation (beyond the reference surface).

    The Green–Kubo linear-response expression

        σ(ω) = (1 / 3 V k_B T) ∫₀^∞ ⟨J(0)·J(t)⟩ cos(ωt) dt,
        J(t) = Σ_i q_i v_i(t),

    is the quantity AC impedance spectroscopy measures; its ω → 0 limit
    is the DC conductivity of
    :class:`~sitator_tpu_torch.dynamics.onsager.OnsagerAnalysis` (the full
    charge-weighted Onsager sum — ion-pairing cross-correlations
    included, since J sums every charge).  Units follow the house
    convention (Å / ps / e / K → S/cm).

    Parameters
    ----------
    groups, charges : species groups (as in ``OnsagerAnalysis``: named
        selections with a SiteTrajectory input, boolean masks with a raw
        one) and their charges in units of e.
    timestep : ps between stored frames.
    temperature : kelvin.
    n_segments : Welch segmentation of the spectrum — the one-shot
        periodogram has O(100%) variance per bin; averaging ``n``
        non-overlapping segments cuts it ~√n at the cost of frequency
        resolution (lowest resolvable frequency rises n-fold).
    integral_window : (lo, hi) fractions of the lag axis over which the
        running Green–Kubo integral is averaged for ``sigma_dc_``
        (plateau readout).  The default (0.01, 0.1) reads shortly after
        a typical current decorrelates — the charge current is a SINGLE
        signal (no per-atom averaging), so every further lag integrates
        pure noise and the long-window variance grows linearly
        (measured 4× std reduction vs (0.1, 0.5) on hopping MD).
        Inspect ``sigma_dc_running_`` and widen it when the current
        decays slowly (strongly back-correlated / viscous systems).

    After ``run``: ``freqs_`` (cycles/ps) and ``sigma_`` (S/cm,
    Welch-averaged, positive by construction); ``times_`` / ``jacf_``
    (the charge-current ACF, e²Å²/ps²); ``sigma_dc_running_``,
    ``sigma_dc_`` (GK plateau, unbiased but single-signal noisy) and
    ``sigma_dc_spectral_`` (mean of the lowest nonzero Welch bins —
    the lowest-variance DC readout, biased high when the conductivity
    still disperses below the segment's frequency resolution).
    ``run`` returns ``self``.
    """

    def __init__(self, groups, charges, timestep=1.0, temperature=300.0,
                 n_segments=8, integral_window=(0.01, 0.1), verbose=True):
        groups = list(groups)
        charges = np.asarray(charges, dtype=np.float64)
        if charges.shape != (len(groups),):
            raise ValueError("charges must have one entry per group")
        if not groups:
            raise ValueError("need at least one species group")
        self.groups = groups
        self.charges = charges
        self.timestep = float(timestep)
        self.temperature = float(temperature)
        self.n_segments = int(n_segments)
        if self.n_segments < 1:
            raise ValueError("n_segments must be >= 1")
        lo, hi = (float(integral_window[0]), float(integral_window[1]))
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError("integral_window must satisfy "
                             "0 <= lo < hi <= 1")
        self.integral_window = (lo, hi)
        self.verbose = verbose

    def _charge_current(self, st_or_traj, cell):
        """J(t) = Σ q_i v_i(t) as ``(F-1, 3)`` float64, plus the cell."""
        from sitator_tpu_torch.dynamics.correlation import resolve_species_groups
        traj, masks, cell, _ = resolve_species_groups(
            st_or_traj, self.groups, cell)
        J = None
        for m, q in zip(masks, self.charges):
            v = _frame_diff_velocities(traj, m, cell, self.timestep)
            contrib = q * v.sum(axis=1)                # (F-1, 3)
            J = contrib if J is None else J + contrib
        return J, np.asarray(cell, dtype=np.float64)

    def run(self, st_or_traj, cell=None):
        from sitator_tpu_torch.ops import msd as msd_ops
        J, cell = self._charge_current(st_or_traj, cell)
        n = J.shape[0]
        if n < 2 * self.n_segments:
            raise ValueError(
                f"{n} velocity frames cannot support "
                f"{self.n_segments} Welch segments")
        # house unit factor: e²·Å²/ps integrated ACF → S/cm, exactly the
        # 1e-8 (Å²/ps → m²/s) + 1e-30 (Å³ → m³) + /100 (S/m → S/cm)
        # convention of DiffusionAnalysis/OnsagerAnalysis
        vol_m3 = float(abs(np.linalg.det(cell))) * 1e-30
        pref = (_E_CHARGE ** 2 * 1e-8
                / (3.0 * vol_m3 * _K_B * self.temperature)) / 100.0

        # charge-current ACF (all origins) and its running GK integral
        Z, _ = msd_ops.vacf_fft(J[:, None, :])
        self.jacf_ = Z
        self.times_ = np.arange(n, dtype=np.float64) * self.timestep
        incr = 0.5 * (Z[1:] + Z[:-1]) * self.timestep
        self.sigma_dc_running_ = pref * np.concatenate(
            [[0.0], np.cumsum(incr)])
        lo = int(round(self.integral_window[0] * (n - 1)))
        hi = max(lo + 1, int(round(self.integral_window[1] * (n - 1))))
        self.sigma_dc_ = float(self.sigma_dc_running_[lo:hi + 1].mean())

        # Welch-averaged spectrum.  Wiener–Khinchin: the two-sided PSD
        # of each component is S_c(f) = ∫ C_c(t) e^{-2πift} dt, so the
        # one-sided cosine transform entering σ is (1/2)·Σ_c S_c(f);
        # the periodogram estimator of S_c is (dt/N)·|FFT(J_c)|².
        seg = n // self.n_segments
        specs = []
        for s in range(self.n_segments):
            part = J[s * seg:(s + 1) * seg]
            specs.append((np.abs(np.fft.rfft(part, axis=0)) ** 2)
                         .sum(axis=1))
        psd = np.mean(specs, axis=0) * self.timestep / seg
        self.freqs_ = np.fft.rfftfreq(seg, d=self.timestep)
        self.sigma_ = 0.5 * pref * psd
        n_low = min(3, len(self.sigma_) - 1)
        self.sigma_dc_spectral_ = (float(self.sigma_[1:1 + n_low].mean())
                                   if n_low > 0 else float("nan"))
        if self.verbose:
            logger.info("sigma(omega): DC plateau %.4g S/cm; spectrum "
                        "over %d segments of %d frames", self.sigma_dc_,
                        self.n_segments, seg)
        return self

