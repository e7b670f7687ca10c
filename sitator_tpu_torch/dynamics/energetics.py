"""Site energetics from occupation statistics — free energies and
transition-state barrier estimates.

Beyond the reference surface but squarely in its ecosystem's workflow
(the landmark-analysis paper's downstream use of site occupancies,
SURVEY.md §1): in equilibrium the relative free energy of site i is

    F_i = -kB T ln(<occ_i> / <occ_ref>)

and a transition-state-theory estimate of the i→j barrier follows from
the observed rate against an attempt frequency ν:

    rate_ij = n_ij / t_i           (jumps per unit time spent at i)
    E_ij    = -kB T ln(rate_ij / ν)

Consistency identity (holds exactly when occupation counts equal
residence time): ``E_ij − E_ji = F_j − F_i`` — the detailed-balance
check ``tests/test_energetics.py`` asserts on synthetic equilibrium
data.

Run :class:`~sitator_tpu_torch.dynamics.jump_analysis.JumpAnalysis` first —
this engine consumes its ``occupancies``, ``total_corrected_residences``
and ``n_ij`` attributes.
"""
from __future__ import annotations

import logging

import numpy as np

__all__ = ["SiteFreeEnergyAnalysis", "PathwayBarrierAnalysis"]

logger = logging.getLogger(__name__)

_K_B_EV = 8.617333262e-5        # eV/K


class SiteFreeEnergyAnalysis:
    """Occupancy-based site free energies (and optional TST barriers).

    Parameters
    ----------
    temperature : kelvin.
    timestep : time per frame — needed (with ``attempt_frequency``) for
        barriers; rates are formed in its inverse unit.
    attempt_frequency : ν in 1/time-unit (e.g. from
        :class:`~sitator_tpu_torch.dynamics.vibrational.
        AverageVibrationalFrequency`); None skips barriers.
    reference : ``'min'`` (most occupied site is F=0, default) or
        ``'mean'``.
    min_jumps : edges with fewer observed jumps get NaN barriers
        (default 1 — a single observed hop is a rate, barely).

    ``run(st)`` adds the site attribute ``site_free_energies`` (eV; NaN
    for never-occupied sites) and, when barriers are enabled, the edge
    attribute ``barriers_ij`` (eV; NaN off the observed jump graph).
    Returns the :class:`SiteTrajectory`.
    """

    def __init__(self, temperature, timestep=1.0, attempt_frequency=None,
                 reference="min", min_jumps=1, verbose=True):
        self.temperature = float(temperature)
        if self.temperature <= 0:
            raise ValueError("temperature must be positive kelvin")
        if reference not in ("min", "mean"):
            raise ValueError("reference must be 'min' or 'mean'")
        self.timestep = float(timestep)
        self.attempt_frequency = (None if attempt_frequency is None
                                  else float(attempt_frequency))
        if self.attempt_frequency is not None and \
                self.attempt_frequency <= 0:
            raise ValueError("attempt_frequency must be positive")
        self.reference = reference
        self.min_jumps = int(min_jumps)
        self.verbose = verbose

    def run(self, st):
        sn = st.site_network
        needed = ["occupancies", "n_ij"]
        if self.attempt_frequency is not None:
            needed.append("total_corrected_residences")
        missing = [a for a in needed
                   if a not in sn.site_attributes
                   and a not in sn.edge_attributes]
        if missing:
            raise ValueError("run JumpAnalysis first (needs "
                             + ", ".join(missing) + ")")
        kT = _K_B_EV * self.temperature
        occ = np.asarray(sn.occupancies, dtype=np.float64)

        with np.errstate(divide="ignore", invalid="ignore"):
            ref = (occ.max() if self.reference == "min"
                   else occ[occ > 0].mean())
            F = np.where(occ > 0, -kT * np.log(occ / ref), np.nan)
        if "site_free_energies" in sn.site_attributes:
            sn.remove_attribute("site_free_energies")
        sn.add_site_attribute("site_free_energies", F)

        if self.attempt_frequency is not None:
            n_ij = np.asarray(sn.n_ij, dtype=np.float64)
            # time spent at i, in time units (occupation counts are
            # frame-counts summed over ions)
            t_i = (np.asarray(sn.total_corrected_residences,
                              dtype=np.float64) * self.timestep)
            with np.errstate(divide="ignore", invalid="ignore"):
                rate = n_ij / t_i[:, None]
                E = -kT * np.log(rate / self.attempt_frequency)
            off_graph = (n_ij < self.min_jumps) | ~(t_i[:, None] > 0)
            E = np.where(off_graph, np.nan, E)
            np.fill_diagonal(E, np.nan)
            if "barriers_ij" in sn.edge_attributes:
                sn.remove_attribute("barriers_ij")
            sn.add_edge_attribute("barriers_ij", E)
            if self.verbose:
                finite = E[np.isfinite(E)]
                if len(finite):
                    logger.info(
                        "barriers: %d edges, median %.3g eV "
                        "(nu = %.3g)", len(finite),
                        float(np.median(finite)), self.attempt_frequency)
        if self.verbose:
            good = F[np.isfinite(F)]
            logger.info("site free energies: spread %.3g eV over %d "
                        "occupied sites", float(np.ptp(good)) if
                        len(good) else float("nan"), len(good))
        return st


def _trilinear_periodic(grid, frac):
    """Periodic trilinear interpolation of a fractional-space grid at
    fractional points ``frac (P, 3)`` (bin CENTERS at (i+0.5)/n)."""
    grid = np.asarray(grid, dtype=np.float64)
    n = np.asarray(grid.shape)
    x = np.asarray(frac, dtype=np.float64) * n - 0.5
    i0 = np.floor(x).astype(np.int64)
    t = x - i0
    out = np.zeros(len(x))
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                idx = (i0 + [di, dj, dk]) % n
                w = (np.where(di, t[:, 0], 1 - t[:, 0])
                     * np.where(dj, t[:, 1], 1 - t[:, 1])
                     * np.where(dk, t[:, 2], 1 - t[:, 2]))
                out += w * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


class PathwayBarrierAnalysis:
    """Free-energy barrier estimates along site-pair pathways from the
    occupation density: in equilibrium ``F(r) = -kB T ln ρ(r)`` up to a
    constant, so the barrier of the i→j hop is read off the density
    profile along the transition path.

    This is the Boltzmann-statistics complement to the two existing
    barrier routes — TST-from-rates
    (:class:`SiteFreeEnergyAnalysis` ``barriers_ij``, needs an attempt
    frequency) and cross-temperature Arrhenius
    (:class:`~sitator_tpu_torch.dynamics.arrhenius.EdgeArrheniusAnalysis`,
    needs a temperature series) — this one needs a single trajectory
    and a temperature, but DOES require the transition region to be
    sampled (rarely-crossed saddles are noisy; never-crossed ones NaN).

    Two path models (``path=``):

    - ``'straight'`` (default): the minimum-image segment between site
      centers — an upper-bound proxy for the true minimum-free-energy
      path; fine for direct interstitial hops, pessimistic for curved
      mechanisms.
    - ``'string'``: the straight segment is relaxed to a genuine
      minimum-energy path on ``-ln rho`` by the simplified string
      method (:func:`sitator_tpu_torch.ops.mep.refine_string_paths` — ALL
      edges relaxed at once on ``device``, gradients of the periodic
      trilinear interpolation).  Always
      gives barriers ≤ the straight readout up to grid resolution, and
      can rescue edges whose straight segment crosses an unsampled
      void.

    Parameters
    ----------
    temperature : kelvin (barriers in eV).
    n_bins, sigma : density grid resolution / smoothing (as in
        :class:`~sitator_tpu_torch.network.density_sites.DensitySiteGenerator`).
    n_samples : points sampled along each path segment.
    min_jumps : only edges with at least this many observed hops (in
        ``n_ij``, when present) are profiled; without ``n_ij``, all
        pairs within ``max_distance`` are.
    max_distance : skip pairs farther apart (minimum image) than this
        (None = no limit).
    path : ``'straight'`` or ``'string'`` (see above).
    string_iterations, string_step : string-method iteration count and
        per-node step cap (length units; None = 0.15 × grid spacing).
    device : where the density grid is accumulated and the strings
        relaxed (default ``"cuda"``).

    After ``run(st)``: edge attr ``density_barrier_ij`` (eV; NaN off
    the jump graph or where the path crosses unsampled density),
    ``profiles_`` — dict ``(i, j) -> (s, F(s))`` arrays (s in Å along
    the path, F relative to the site-i end) — and ``paths_`` — dict
    ``(i, j) -> (n_samples, 3)`` cartesian path nodes (site-i end
    first).  Returns ``self``.
    """

    def __init__(self, temperature, n_bins=48, sigma=0.5, n_samples=33,
                 min_jumps=1, max_distance=None, path="straight",
                 string_iterations=300, string_step=None, verbose=True,
                 device="cuda"):
        self.temperature = float(temperature)
        if self.temperature <= 0:
            raise ValueError("temperature must be positive kelvin")
        self.n_bins = int(n_bins)
        self.sigma = float(sigma)
        self.n_samples = int(n_samples)
        if self.n_samples < 3:
            raise ValueError("n_samples must be at least 3")
        self.min_jumps = int(min_jumps)
        self.max_distance = max_distance
        if path not in ("straight", "string"):
            raise ValueError("path must be 'straight' or 'string'")
        self.path = path
        self.string_iterations = int(string_iterations)
        self.string_step = string_step
        self.verbose = verbose
        self.device = device

    def run(self, st):
        from sitator_tpu_torch.network.compare import min_image_distance_matrix
        from sitator_tpu_torch.ops import density as density_ops
        from sitator_tpu_torch.ops.pbc import PBCCalculator

        sn = st.site_network
        traj = st.real_trajectory
        if traj is None:
            raise ValueError(
                "SiteTrajectory has no real trajectory (set_real_traj)")
        cell = np.asarray(sn.structure.cell, dtype=np.float64)
        centers = np.asarray(sn.centers, dtype=np.float64)
        S = sn.n_sites

        grid = density_ops.density_grid(
            traj, cell, mask=sn.mobile_mask, n_bins=self.n_bins,
            device=self.device)
        rho = density_ops.smooth_density(grid, cell, self.sigma)

        # candidate edges: the observed jump graph when available
        if sn.has_attribute("n_ij"):
            n_ij = np.asarray(sn.n_ij)
            pairs = [(i, j) for i in range(S) for j in range(i + 1, S)
                     if n_ij[i, j] + n_ij[j, i] >= self.min_jumps]
        else:
            pairs = [(i, j) for i in range(S) for j in range(i + 1, S)]
        if self.max_distance is not None:
            D = min_image_distance_matrix(centers, centers, cell)
            pairs = [(i, j) for i, j in pairs
                     if D[i, j] <= self.max_distance]

        kT = _K_B_EV * self.temperature
        calc = PBCCalculator(cell)
        inv = np.linalg.inv(cell)
        E = np.full((S, S), np.nan)
        self.profiles_ = {}
        self.paths_ = {}
        s_par = np.linspace(0.0, 1.0, self.n_samples)
        all_pts = np.empty((len(pairs), self.n_samples, 3))
        for k, (i, j) in enumerate(pairs):
            d = np.asarray(calc._min_image_disp(
                (centers[j] - centers[i])[None]))[0]
            all_pts[k] = centers[i][None] + s_par[:, None] * d[None]
        if self.path == "string" and len(pairs):
            from sitator_tpu_torch.ops.mep import refine_string_paths
            all_pts = refine_string_paths(
                rho, cell, all_pts, iterations=self.string_iterations,
                max_step=self.string_step, device=self.device)
        for k, (i, j) in enumerate(pairs):
            pts = all_pts[k]
            frac = pts @ inv
            frac -= np.floor(frac)
            prof = _trilinear_periodic(rho, frac)
            if prof.min() <= 0:            # unsampled transition region
                continue
            F_path = -kT * np.log(prof / prof[0])
            # barrier relative to each end (max over the path interior)
            peak = F_path.max()
            E[i, j] = peak - F_path[0]      # == peak (F[0] = 0)
            E[j, i] = peak - F_path[-1]
            seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
            self.profiles_[(i, j)] = (
                np.concatenate([[0.0], np.cumsum(seg)]), F_path)
            self.paths_[(i, j)] = pts
        if "density_barrier_ij" in sn.edge_attributes:
            sn.remove_attribute("density_barrier_ij")
        sn.add_edge_attribute("density_barrier_ij", E)
        if self.verbose:
            finite = E[np.isfinite(E)]
            logger.info(
                "density barriers: %d directed edges profiled, median "
                "%.3g eV", len(finite),
                float(np.median(finite)) if len(finite) else
                float("nan"))
        return self
