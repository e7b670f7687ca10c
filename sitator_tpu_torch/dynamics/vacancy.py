"""Vacancy tracking — unoccupied sites as labeled quasi-particles.

Beyond-reference capability (upstream ``sitator`` analyzes only the
ions, SURVEY.md §3.4): in many solid electrolytes the mobile-ion
sublattice is nearly full and transport is **vacancy-mediated** — the
physically meaningful random walker is the hole, not any single ion
(one vacancy hop moves one ion one site, so the vacancy samples the
lattice far faster than any ion).  This module inverts the site
trajectory: per frame, the set of unoccupied sites; across frames,
vacancy *identities* maintained by minimum-image optimal assignment
(Hungarian on the site-center distance matrix, the same machinery as
:mod:`sitator_tpu_torch.network.compare`).

The result is a :class:`SiteTrajectory` whose "mobile particles" are
the vacancies, so the whole label-based toolchain —
:class:`~sitator_tpu_torch.dynamics.JumpAnalysis`,
:class:`~sitator_tpu_torch.dynamics.SiteDiffusionAnalysis` (vacancy
diffusivity), :class:`~sitator_tpu_torch.dynamics.ResidenceTimeAnalysis` —
runs on them unchanged.

Host-side (one O(F · V³) pass; V = vacancies per frame is small by
definition of the dilute-vacancy regime).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory
from sitator_tpu_torch.core.structure import Structure

logger = logging.getLogger(__name__)

__all__ = ["VacancyAnalysis"]


class VacancyAnalysis:
    """Extract the vacancy trajectory from an ion site trajectory.

    Parameters
    ----------
    unknown_policy : ``'persist'`` (default) forward-fills unassigned
        ion labels before computing occupations, so a briefly-unassigned
        ion does not spuriously vacate its site; ``'strict'`` treats
        unassigned ions as occupying nothing.
    max_step : optional distance ceiling (same unit as the cell) for a
        vacancy identity to carry between consecutive frames; a vacancy
        forced to "move" farther (e.g. one annihilates while another
        appears elsewhere) starts a NEW identity, leaving the old
        walker at ``SITE_UNKNOWN`` from then on.

    ``run(st)`` returns a :class:`SiteTrajectory` over a pseudo-network
    with one mobile pseudo-particle per vacancy IDENTITY (the same host
    structure and site centers/types): a column is one vacancy's
    lifetime, ``SITE_UNKNOWN`` before its birth and after its death, so
    downstream jump statistics never see a fake teleport when one
    vacancy annihilates while another appears elsewhere.  After
    ``run``: ``n_vacancies_`` (per-frame count), ``n_identities_``,
    ``n_rebirths_`` (identities born after frame 0).

    Caveat: ``SiteDiffusionAnalysis`` on the output is unbiased only
    for STABLE identities (``n_rebirths_ == 0``) — its label filling
    holds a dead/unborn column at a constant position, diluting the
    column-averaged MSD slope; ``run`` warns when identities churn.
    Jump statistics and residence analyses are lifetime-aware and
    remain exact.
    """

    def __init__(self, unknown_policy="persist", max_step=None,
                 verbose=True):
        if unknown_policy not in ("persist", "strict"):
            raise ValueError("unknown_policy must be 'persist' or "
                             "'strict'")
        self.unknown_policy = unknown_policy
        self.max_step = None if max_step is None else float(max_step)
        self.verbose = verbose

    @staticmethod
    def _filled(labels):
        """Forward-fill -1 ion labels (JumpAnalysis 'persist' parity)."""
        from sitator_tpu_torch.core.sitetraj import forward_fill_labels
        return forward_fill_labels(labels, leading="unknown")

    def run(self, st):
        from scipy.optimize import linear_sum_assignment

        from sitator_tpu_torch.network.compare import min_image_distance_matrix

        sn = st.site_network
        S = sn.n_sites
        if S == 0:
            raise ValueError("site network has no sites")
        labels = (self._filled(st.traj)
                  if self.unknown_policy == "persist"
                  else np.asarray(st.traj, dtype=np.int64))
        F = labels.shape[0]
        centers = np.asarray(sn.centers, dtype=np.float64)
        D = min_image_distance_matrix(centers, centers,
                                      sn.structure.cell)

        # per-frame vacancy site sets
        occupied = np.zeros((F, S), dtype=bool)
        frames = np.repeat(np.arange(F), labels.shape[1])
        flat = labels.ravel()
        ok = flat >= 0
        occupied[frames[ok], flat[ok]] = True
        vac_sets = [np.flatnonzero(~occupied[f]) for f in range(F)]
        counts = np.array([len(v) for v in vac_sets])
        if counts.max() == 0:
            raise ValueError("no vacancies: every site is occupied in "
                             "every frame")

        # identity tracking: every identity owns a column for its whole
        # lifetime; a vacancy that cannot be matched (or is farther
        # than max_step) dies and the new one is a NEW identity
        ident_site = []                 # current site per identity; -1 dead
        frames_records = []             # per frame: [(identity, site)]
        rebirths = 0
        big = max(1.0, D.max()) * 1e6
        for f in range(F):
            cur = vac_sets[f]
            alive = [i for i, s in enumerate(ident_site) if s >= 0]
            record = []
            taken = np.zeros(len(cur), dtype=bool)
            matched = {}
            if alive and len(cur):
                cost = D[np.ix_([ident_site[i] for i in alive], cur)]
                if self.max_step is not None:
                    cost = np.where(cost > self.max_step, big, cost)
                rows, cols = linear_sum_assignment(cost)
                for r, c in zip(rows, cols):
                    if (self.max_step is not None
                            and D[ident_site[alive[r]],
                                  cur[c]] > self.max_step):
                        continue
                    matched[alive[r]] = int(cur[c])
                    taken[c] = True
            # deaths happen OUTSIDE the matching guard: on a
            # zero-vacancy frame every identity annihilates — keeping
            # it alive would resurrect it at a later vacancy's site and
            # fake the very teleport-jump this tracking prevents
            for i in alive:
                if i in matched:
                    ident_site[i] = matched[i]
                    record.append((i, matched[i]))
                else:
                    ident_site[i] = -1              # death
            for c in np.flatnonzero(~taken):
                ident_site.append(int(cur[c]))      # birth
                record.append((len(ident_site) - 1, int(cur[c])))
                if f > 0:
                    rebirths += 1
            frames_records.append(record)

        n_ident = len(ident_site)
        out = np.full((F, n_ident), SiteTrajectory.SITE_UNKNOWN,
                      dtype=np.int32)
        for f, record in enumerate(frames_records):
            for i, s in record:
                out[f, i] = s

        out_sn = self._pseudo_network(sn, n_ident)
        vt = SiteTrajectory(out_sn, out)
        self.n_vacancies_ = counts
        self.n_identities_ = n_ident
        self.n_rebirths_ = rebirths
        if rebirths:
            logger.warning(
                "%d vacancy identity rebirth(s): columns have finite "
                "lifetimes, so a naive column-averaged MSD "
                "(SiteDiffusionAnalysis) underestimates D_vac — use "
                "jump statistics, or analyze stretches with stable "
                "identities", rebirths)
        if self.verbose:
            logger.info(
                "vacancies: %d identit%s, count %d-%d per frame, %d "
                "rebirths", n_ident, "y" if n_ident == 1 else "ies",
                counts.min(), counts.max(), rebirths)
        return vt

    @staticmethod
    def _pseudo_network(sn, n_slots):
        host = sn.structure
        static_idx = np.flatnonzero(sn.static_mask)
        pos = np.concatenate([host.positions[static_idx],
                              np.zeros((n_slots, 3))], axis=0)
        species = np.concatenate([host.species[static_idx],
                                  np.zeros(n_slots, dtype=np.int32)])
        structure = Structure(pos, species, host.cell, pbc=host.pbc)
        n_static = len(static_idx)
        static_mask = np.zeros(n_static + n_slots, dtype=bool)
        static_mask[:n_static] = True
        out = SiteNetwork(structure, static_mask, ~static_mask)
        out.centers = np.asarray(sn.centers).copy()
        if sn.site_types is not None:
            out.site_types = sn.site_types.copy()
        return out
