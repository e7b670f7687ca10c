"""Onsager transport coefficients between ionic species.

Beyond the reference surface (upstream ``sitator`` stops at jump
statistics, SURVEY.md §3.4): the full linear-response transport matrix
of a multi-species conductor,

    Λ_ab = lim_t  ⟨ ΔR_a(t) · ΔR_b(t) ⟩ / (6 t),
    R_a(t) = Σ_{i ∈ a} r_i(t)   (unwrapped),

the extensive generalization of the collective (charge) diffusivity:
for a single species ``Λ_aa = M · D_collective`` and the conductivity
formula reduces exactly to
:class:`~sitator_tpu_torch.dynamics.diffusion.DiffusionAnalysis`'s
Nernst–Einstein-with-correlations value (tested).  Off-diagonal terms
are the cation–cation / cation–anion correlations that make real
electrolytes deviate from Nernst–Einstein: ion pairing drives
``Σ_ab z_a z_b Λ_ab`` (and hence the conductivity) to zero even when
every self term is large.

All curves use the all-origins FFT estimator
(:func:`~sitator_tpu_torch.ops.msd.cross_msd_fft`) on host float64 — the
S1 − S2 identity cancels catastrophically in f32, and this runs once
per trajectory.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.ops import msd as msd_ops
from sitator_tpu_torch.dynamics.correlation import (_resolve_mask,
                                              resolve_species_groups)
from sitator_tpu_torch.dynamics.diffusion import (_check_fit_range, _E_CHARGE,
                                            _K_B)

__all__ = ["OnsagerAnalysis"]

logger = logging.getLogger(__name__)


class OnsagerAnalysis:
    """Onsager matrix over the given species ``groups`` (each a
    selection: ``'mobile'``, ``'static'``, a species number, or a
    boolean atom mask; groups must be disjoint).

    After ``run(st)`` (or a raw trajectory plus ``cell`` with
    boolean-mask groups):

    - ``L_``: the ``(n, n)`` symmetric Onsager matrix Λ_ab (extensive,
      length²/time units of the input),
    - ``msd_cross_`` (``(n, n, F)`` curves) and ``times_``,
    - ``n_atoms_``: ions per group,
    - with ``charges`` (per group, units of e) and ``temperature``:
      ``conductivity_`` (S/cm; Å/ps/K convention, NaN when the charge-
      weighted sum is non-positive) and ``transference_`` — the ionic
      transference numbers t_a = Σ_b z_a z_b Λ_ab / Σ_cd z_c z_d Λ_cd
      (sum to 1 when defined).

    ``drift_correction`` picks the reference frame the matrix is
    measured in — Onsager coefficients (unlike the conductivity of a
    charge-neutral system) are frame-dependent, so this matters for
    transference numbers: ``None`` (lab/simulation frame, default),
    ``'all'`` (the unweighted mean frame of every atom — the standard
    barycentric convention for equal-mass accounting; makes the
    group-summed displacement vanish identically when the groups
    partition all atoms), ``'static'``/``'mobile'``/a species number
    (SiteTrajectory input only), or a boolean ``(n_atoms,)`` mask
    (e.g. the host lattice).  Each group coordinate is shifted by
    ``N_a ×`` the reference drift; the curve lands in ``drift_``.

    ``run`` returns ``self``.
    """

    def __init__(self, groups, timestep=1.0, fit_range=(0.2, 0.5),
                 temperature=None, charges=None, exact_unwrap=False,
                 drift_correction=None, verbose=True):
        groups = list(groups)
        if len(groups) < 1:
            raise ValueError("need at least one species group")
        self.groups = groups
        self.timestep = float(timestep)
        self.fit_range = _check_fit_range(fit_range)
        self.temperature = (None if temperature is None
                            else float(temperature))
        if charges is not None:
            charges = np.asarray(charges, dtype=np.float64)
            if charges.shape != (len(groups),):
                raise ValueError("charges must have one entry per group")
        self.charges = charges
        self.exact_unwrap = bool(exact_unwrap)
        self.drift_correction = drift_correction
        self.verbose = verbose

    def _drift_mask(self, traj, sn):
        """Resolve ``drift_correction`` to a reference mask (None =
        every atom); raises for named selections without a network."""
        spec = self.drift_correction
        if isinstance(spec, str) and spec == "all":
            return None
        if isinstance(spec, str) or np.isscalar(spec):
            if sn is None:
                raise ValueError(
                    f"drift_correction={spec!r} needs a SiteTrajectory "
                    "input (raw trajectories take 'all' or a mask)")
            return _resolve_mask(spec, sn)
        mask = np.asarray(spec, dtype=bool)
        if mask.shape != (traj.shape[1],):
            raise ValueError("drift_correction mask must be (n_atoms,)")
        return mask

    def run(self, st_or_traj, cell=None):
        traj, masks, cell, sn = resolve_species_groups(
            st_or_traj, self.groups, cell)
        n = len(masks)
        stacked = np.stack(masks)
        self.n_atoms_ = stacked.sum(axis=1).astype(int)
        F = traj.shape[0]
        if F < 8:
            raise ValueError(f"need at least 8 frames, got {F}")

        union = stacked.any(axis=0)
        unwrapped = msd_ops.unwrap_trajectory(
            traj[:, union, :], cell, exact=self.exact_unwrap)
        idx_in_union = np.cumsum(union) - 1
        # summed (collective) coordinate per group, (n, F, 3)
        R = np.stack([unwrapped[:, idx_in_union[m], :].sum(axis=1)
                      for m in masks])
        self.drift_ = None
        if self.drift_correction is not None:
            self.drift_ = msd_ops.drift_curve(
                traj, cell, self._drift_mask(traj, sn),
                exact=self.exact_unwrap)
            # R_a is a sum over N_a atoms — the frame shift scales by N_a
            R = R - (self.n_atoms_[:, None, None].astype(np.float64)
                     * self.drift_[None, :, :])

        self.times_ = np.arange(F, dtype=np.float64) * self.timestep
        self.msd_cross_ = np.empty((n, n, F))
        self.L_ = np.empty((n, n))
        for a in range(n):
            for b in range(a, n):
                curve = msd_ops.cross_msd_fft(R[a], R[b])
                self.msd_cross_[a, b] = self.msd_cross_[b, a] = curve
                lam, _ = msd_ops.fit_diffusivity(
                    self.times_, curve, self.fit_range)
                self.L_[a, b] = self.L_[b, a] = lam

        self.conductivity_ = None
        self.transference_ = None
        if self.charges is not None:
            z = self.charges
            zLz_raw = float(z @ self.L_ @ z)
            # catastrophic cancellation (perfect ion pairing) leaves an
            # fp residue ~1e-16 of the gross scale: treat as zero
            gross = float(np.abs(z) @ np.abs(self.L_) @ np.abs(z))
            zLz = 0.0 if zLz_raw <= 1e-12 * gross else zLz_raw
            if zLz > 0:
                self.transference_ = (z * (self.L_ @ z)) / zLz
            else:
                self.transference_ = np.full(n, np.nan)
            if self.temperature is not None:
                if zLz > 0:
                    vol_m3 = float(abs(np.linalg.det(cell))) * 1e-30
                    sigma_sm = (_E_CHARGE ** 2 * zLz * 1e-8
                                / (vol_m3 * _K_B * self.temperature))
                    self.conductivity_ = sigma_sm / 100.0
                else:
                    self.conductivity_ = float("nan")
                    logger.warning(
                        "charge-weighted Onsager sum is non-positive "
                        "(%.3g) — conductivity_ set to NaN (ion pairing "
                        "or insufficient statistics)", zLz_raw)
        if self.verbose:
            logger.info("Onsager matrix (extensive):\n%s", self.L_)
        return self
