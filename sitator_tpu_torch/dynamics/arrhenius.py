"""Arrhenius analysis — activation energy from a temperature series.

Closes the kinetics loop opened by :mod:`sitator_tpu_torch.dynamics.diffusion`
(beyond the reference surface, SURVEY.md §3.4): given diffusivities (or
jump rates, or conductivity·T products — anything Arrhenius-activated)
measured at several temperatures, fit ``ln y = ln y0 - Ea / (kB T)`` by
(optionally error-weighted) least squares and report the activation
energy with a covariance-derived uncertainty.
"""
from __future__ import annotations

import logging

import numpy as np

__all__ = ["ArrheniusAnalysis", "EdgeArrheniusAnalysis"]

logger = logging.getLogger(__name__)

_K_B_EV = 8.617333262e-5        # eV/K


class ArrheniusAnalysis:
    """Fit ``y(T) = y0 * exp(-Ea / kB T)``.

    ``run(temperatures, values, errors=None)`` with temperatures in
    kelvin; ``errors`` are 1-sigma uncertainties of ``values`` (used as
    weights and propagated into the parameter covariance).  After
    ``run``: ``Ea_ev_``, ``Ea_err_ev_``, ``prefactor_``,
    ``log_prefactor_err_``, ``residuals_`` (in ln-space); returns
    ``self``.  ``predict(T)`` evaluates the fit.
    """

    def __init__(self, verbose=True):
        self.verbose = verbose

    def run(self, temperatures, values, errors=None):
        T = np.asarray(temperatures, dtype=np.float64)
        y = np.asarray(values, dtype=np.float64)
        if T.shape != y.shape or T.ndim != 1:
            raise ValueError("temperatures and values must be equal-length "
                             "1-D arrays")
        if len(T) < 2:
            raise ValueError("need at least 2 temperatures")
        if (T <= 0).any():
            raise ValueError("temperatures must be positive kelvin")
        if (y <= 0).any():
            raise ValueError("values must be positive (Arrhenius is a fit "
                             "in ln space)")
        if np.unique(T).size < 2:
            raise ValueError("temperatures must contain at least 2 "
                             "distinct values")
        x = 1.0 / T
        ln_y = np.log(y)
        if errors is not None:
            errors = np.asarray(errors, dtype=np.float64)
            if (errors <= 0).any():
                raise ValueError("errors must be positive")
            w = y / errors                 # d(ln y) = dy / y
        else:
            w = np.ones_like(y)

        # weighted linear fit ln_y = b + m * x, m = -Ea/kB
        A = np.stack([x, np.ones_like(x)], axis=1) * w[:, None]
        coef, *_ = np.linalg.lstsq(A, ln_y * w, rcond=None)
        m, b = coef
        resid = ln_y - (b + m * x)
        # parameter covariance: sigma^2 * (A^T A)^-1 with sigma^2 from
        # residuals when unweighted / unit-weight chi^2 otherwise
        dof = max(1, len(T) - 2)
        cov = np.linalg.inv(A.T @ A)
        if errors is None:
            cov = cov * float((resid ** 2 * w ** 2).sum() / dof)
        self.Ea_ev_ = float(-m * _K_B_EV)
        self.Ea_err_ev_ = float(np.sqrt(cov[0, 0]) * _K_B_EV)
        self.prefactor_ = float(np.exp(b))
        self.log_prefactor_err_ = float(np.sqrt(cov[1, 1]))
        self.residuals_ = resid
        if self.verbose:
            logger.info("Ea = %.4g ± %.2g eV, prefactor = %.4g",
                        self.Ea_ev_, self.Ea_err_ev_, self.prefactor_)
        return self

    def predict(self, temperatures):
        T = np.asarray(temperatures, dtype=np.float64)
        return self.prefactor_ * np.exp(-self.Ea_ev_ / (_K_B_EV * T))


class EdgeArrheniusAnalysis:
    """Site- and edge-resolved activation energies over a temperature
    series.

    Goes one level deeper than :class:`ArrheniusAnalysis` (which fits a
    single scalar per series): for **every jump pathway** ``i → j`` of
    the site network, fit ``ln k_ij(T) = ln ν_ij − Ea_ij/(k_B T)`` where
    ``k_ij = n_ij / t_i`` is the per-frame escape rate measured by
    :class:`JumpAnalysis` at each temperature.  Because independent
    analyses number their sites independently, every network in the
    series is first matched onto the first one (the *reference*) with
    :func:`sitator_tpu_torch.network.match_sites` — run each temperature's
    pipeline separately and hand the resulting networks straight in.

    Parameters
    ----------
    min_points : minimum temperatures at which an edge must be observed
        (with ``n_ij >= min_counts``) to be fitted.
    min_counts : minimum hop count for a (temperature, edge) point to
        enter its fit (tiny counts make ``ln k`` meaningless).
    match_cutoff : maximum minimum-image distance for cross-temperature
        site identification (None = unlimited).

    ``run(series)`` with ``series`` an iterable of ``(temperature_K,
    SiteNetwork)`` pairs, each network carrying JumpAnalysis attributes.
    Fits are weighted by hop counts (Poisson: ``var(ln k) ≈ 1/n``).
    Rates are per frame; a constant timestep factor only shifts
    ``ln ν``, so ``Ea`` is timestep-invariant (use equal timesteps
    across the series, or convert yourself if they differ).

    After ``run`` (returns ``self``): ``Ea_ij_`` (S, S) eV (NaN where
    unfittable), ``lnnu_ij_``, ``n_points_ij_``, ``Ea_site_`` (per-site
    total-escape-rate fit), ``mappings_`` (list of reference→network
    site maps).  Writes ``Ea_ij`` (edge) and ``Ea_site`` (site)
    attributes onto the reference network.
    """

    def __init__(self, min_points=2, min_counts=3, match_cutoff=None,
                 verbose=True):
        self.min_points = int(min_points)
        if self.min_points < 2:
            raise ValueError("min_points must be >= 2 (a line needs "
                             "two temperatures)")
        self.min_counts = int(min_counts)
        self.match_cutoff = match_cutoff
        self.verbose = verbose

    @staticmethod
    def _rates_in_reference(ref, sn, mapping):
        """(rates, counts) of ``sn`` expressed in the reference site
        numbering; NaN/0 where the reference site is unmatched."""
        S = ref.n_sites
        n_ij = np.asarray(sn.n_ij, dtype=np.float64).copy()
        np.fill_diagonal(n_ij, 0.0)
        t_i = np.asarray(sn.total_corrected_residences, dtype=np.float64)
        rates = np.full((S, S), np.nan)
        counts = np.zeros((S, S))
        ok = mapping >= 0
        mi = mapping[ok]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(t_i[:, None] > 0, n_ij / t_i[:, None], np.nan)
        rates[np.ix_(ok, ok)] = r[np.ix_(mi, mi)]
        counts[np.ix_(ok, ok)] = n_ij[np.ix_(mi, mi)]
        return rates, counts

    def run(self, series):
        from sitator_tpu_torch.network.compare import match_sites

        series = list(series)
        if len(series) < 2:
            raise ValueError("need at least 2 (temperature, network) "
                             "pairs")
        temps = np.array([float(t) for t, _ in series])
        if (temps <= 0).any():
            raise ValueError("temperatures must be positive kelvin")
        if np.unique(temps).size < 2:
            raise ValueError("temperatures must contain at least 2 "
                             "distinct values")
        nets = [sn for _, sn in series]
        for sn in nets:
            if not (sn.has_attribute("n_ij")
                    and sn.has_attribute("total_corrected_residences")):
                raise ValueError("every network needs JumpAnalysis "
                                 "attributes (n_ij, "
                                 "total_corrected_residences)")
        ref = nets[0]
        S = ref.n_sites
        self.mappings_ = [np.arange(S, dtype=np.int64)]
        rates = np.empty((len(series), S, S))
        counts = np.empty((len(series), S, S))
        rates[0], counts[0] = self._rates_in_reference(
            ref, ref, self.mappings_[0])
        for k, sn in enumerate(nets[1:], start=1):
            mapping, _ = match_sites(ref, sn, cutoff=self.match_cutoff)
            self.mappings_.append(mapping)
            rates[k], counts[k] = self._rates_in_reference(
                ref, sn, mapping)

        x = 1.0 / temps                                  # (K,)
        self.Ea_ij_, self.lnnu_ij_, self.n_points_ij_ = self._fit(
            x, rates, counts)
        # per-site total escape rate (sum over destinations)
        site_counts = np.nansum(counts, axis=2)
        with np.errstate(invalid="ignore"):
            site_rates = np.nansum(np.where(np.isnan(rates), 0.0, rates),
                                   axis=2)
        site_rates = np.where(np.isnan(rates).all(axis=2), np.nan,
                              site_rates)
        Ea_s, _, _ = self._fit(x, site_rates[:, :, None],
                               site_counts[:, :, None])
        self.Ea_site_ = Ea_s[:, 0]
        for name, arr, adder in (
                ("Ea_ij", self.Ea_ij_, ref.add_edge_attribute),
                ("Ea_site", self.Ea_site_, ref.add_site_attribute)):
            if ref.has_attribute(name):
                ref.remove_attribute(name)
            adder(name, arr)
        if self.verbose:
            good = self.Ea_ij_[np.isfinite(self.Ea_ij_)]
            logger.info(
                "edge Arrhenius: %d/%d edges fitted over %d temperatures"
                "%s", good.size, S * (S - 1), len(series),
                f", median Ea = {np.median(good):.3g} eV" if good.size
                else "")
        return self

    def _fit(self, x, rates, counts):
        """Vectorized weighted ln-rate vs 1/T regression.  ``rates`` /
        ``counts`` are (K, ...) stacks; returns (Ea_eV, ln_nu, n_points)
        of the trailing shape, NaN where unfittable."""
        valid = (np.isfinite(rates) & (rates > 0)
                 & (counts >= self.min_counts))
        w = np.where(valid, counts, 0.0)                 # Poisson weights
        y = np.where(valid, np.log(np.where(valid, rates, 1.0)), 0.0)
        xs = x.reshape((-1,) + (1,) * (rates.ndim - 1))
        sw = w.sum(0)
        swx = (w * xs).sum(0)
        swy = (w * y).sum(0)
        swxx = (w * xs * xs).sum(0)
        swxy = (w * xs * y).sum(0)
        denom = sw * swxx - swx ** 2
        n_points = valid.sum(0)
        # a line needs >= min_points AND >=2 distinct temperatures: when
        # all weight sits at one x the denominator is zero up to
        # rounding, so gate it relative to its natural scale sw*swxx
        ok = (n_points >= self.min_points) & (denom > 1e-12 * sw * swxx)
        with np.errstate(divide="ignore", invalid="ignore"):
            slope = np.where(ok, (sw * swxy - swx * swy) / denom, np.nan)
            intercept = np.where(ok, (swy - slope * swx) / sw, np.nan)
        return -slope * _K_B_EV, intercept, n_points
