"""Site seeding from bond-valence-sum mismatch —
``BondValenceSiteGenerator``.

Beyond the reference surface (upstream ``sitator`` seeds sites only via
Zeo++, SURVEY.md §3.3): the chemistry-driven member of the seeding
triad — :class:`~sitator_tpu_torch.voronoi.generator.VoronoiSiteGenerator`
works from empty-lattice geometry, :class:`DensitySiteGenerator` from
the trajectory, and this generator from the static structure plus two
empirical bond-valence constants: plausible cation sites are the local
minima of ``|V(r) − V_ideal|``, the softBV-style mismatch map of
:mod:`sitator_tpu_torch.ops.bondvalence` (evaluated on device).  No
trajectory needed, and unlike the Voronoi route it knows which voids
are chemically sensible for THIS cation.

The produced network carries ``vertices`` (nearest static atoms, so it
drops straight into ``LandmarkAnalysis``), plus site attributes
``bv_mismatch`` (each site's refined-map mismatch) and ``bv_sum``
(the exact bond-valence sum re-evaluated at the refined center).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.structure import number_to_symbol, symbol_to_number
from sitator_tpu_torch.network.compare import min_image_distance_matrix
from sitator_tpu_torch.ops import bondvalence as bv_ops
from sitator_tpu_torch.ops.density import find_density_peaks

__all__ = ["BondValenceSiteGenerator"]

logger = logging.getLogger(__name__)


class BondValenceSiteGenerator:
    """``run(sn_without_sites) -> SiteNetwork`` whose centers are the
    bond-valence-mismatch minima of the static counter-ion sublattice.

    Parameters
    ----------
    cation : probe cation symbol; default: the (single) mobile species
        of the input network.
    v_ideal : the cation's formal valence (target bond-valence sum).
    anions : counter-ion selection among the static atoms — a species
        symbol/number, a list of them, or a boolean ``(n_atoms,)``
        mask.  Default: every static atom (each species then needs an
        ``R0`` entry).
    r0 : bond-valence ``R0`` in Å — a scalar, a per-anion array, or
        ``None`` to look each (cation, anion-species) pair up in
        :data:`~sitator_tpu_torch.ops.bondvalence.BV_R0` (nominal
        Brese–O'Keeffe values — verify for production chemistry).
    b, cutoff : bond-valence softness (Å) and interaction cutoff (Å).
    mismatch_tol : accept minima with ``|V − V_ideal| <`` this (valence
        units) — the standard softBV-style acceptance knob.
    n_bins, min_distance, n_vertices : grid resolution, minimum-image
        peak separation, and landmark vertex count (as in
        :class:`~sitator_tpu_torch.network.density_sites.DensitySiteGenerator`).
    device : where the bond-valence sums are evaluated (default
        ``"cuda"``).
    """

    def __init__(self, cation=None, v_ideal=1.0, anions=None, r0=None,
                 b=bv_ops.BV_B, cutoff=6.0, mismatch_tol=0.3,
                 n_bins=48, min_distance=1.0, n_vertices=8,
                 verbose=True, device="cuda"):
        if mismatch_tol <= 0:
            raise ValueError("mismatch_tol must be positive")
        if n_vertices < 1:
            raise ValueError("n_vertices must be at least 1")
        self.cation = cation
        self.v_ideal = float(v_ideal)
        self.anions = anions
        self.r0 = r0
        self.b = float(b)
        self.cutoff = float(cutoff)
        self.mismatch_tol = float(mismatch_tol)
        self.n_bins = int(n_bins)
        self.min_distance = float(min_distance)
        self.n_vertices = int(n_vertices)
        self.verbose = verbose
        self.device = device

    # -- selection plumbing -------------------------------------------
    def _anion_mask(self, sn):
        static = np.asarray(sn.static_mask, dtype=bool)
        sel = self.anions
        if sel is None:
            return static
        arr = np.asarray(sel)
        if arr.dtype == bool:
            if arr.shape != (sn.structure.n_atoms,):
                raise ValueError("anion mask must be (n_atoms,)")
            if (arr & ~static).any():
                raise ValueError("anion mask selects non-static atoms")
            return arr
        species = np.atleast_1d(sel)
        nums = [symbol_to_number(s) if isinstance(s, str) else int(s)
                for s in species]
        mask = static & np.isin(sn.structure.species, nums)
        if not mask.any():
            raise ValueError(f"no static atoms of species {list(species)}")
        return mask

    def _cation_symbol(self, sn):
        if self.cation is not None:
            return self.cation
        mobile_species = np.unique(
            np.asarray(sn.structure.species)[sn.mobile_mask])
        if len(mobile_species) != 1:
            raise ValueError(
                "cation= is required when the mobile selection has "
                f"{len(mobile_species)} species")
        return number_to_symbol(int(mobile_species[0]))

    def _r0_per_anion(self, sn, anion_mask, cation):
        if self.r0 is not None:
            r0 = np.broadcast_to(
                np.asarray(self.r0, dtype=np.float64),
                (int(anion_mask.sum()),))
            return np.array(r0)
        species = np.asarray(sn.structure.species)[anion_mask]
        r0 = np.empty(len(species))
        for z in np.unique(species):
            key = (cation, number_to_symbol(int(z)))
            if key not in bv_ops.BV_R0:
                raise ValueError(
                    f"no tabulated bond-valence R0 for {key} — pass "
                    "r0= explicitly (or narrow anions=)")
            r0[species == z] = bv_ops.BV_R0[key]
        return r0

    # -- the generator -------------------------------------------------
    def run(self, sn: SiteNetwork) -> SiteNetwork:
        cation = self._cation_symbol(sn)
        anion_mask = self._anion_mask(sn)
        anions = sn.structure.positions[anion_mask]
        cell = np.asarray(sn.structure.cell, dtype=np.float64)
        r0 = self._r0_per_anion(sn, anion_mask, cation)

        mism = bv_ops.bv_mismatch_grid(
            anions, r0, cell, self.v_ideal, n_bins=self.n_bins,
            b=self.b, cutoff=self.cutoff, device=self.device)
        # minima of the mismatch below tol == peaks of the clipped score
        score = np.maximum(0.0, self.mismatch_tol - mism)
        if score.max() <= 0:
            raise ValueError(
                f"no grid point reaches |V - {self.v_ideal:g}| < "
                f"{self.mismatch_tol:g} (best mismatch "
                f"{mism.min():.3g}) — check r0/anions or raise "
                "mismatch_tol")
        centers, scores = find_density_peaks(
            score, cell, threshold_rel=1e-9,
            min_distance=self.min_distance)

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = centers
        static_idx = np.flatnonzero(sn.static_mask).astype(np.int32)
        k = min(self.n_vertices, len(static_idx))
        static_pos = sn.structure.positions[static_idx]
        D = min_image_distance_matrix(centers, static_pos, cell)
        out.vertices = [static_idx[row]
                        for row in np.argsort(D, axis=1)[:, :k]]
        out.add_site_attribute("bv_mismatch",
                               self.mismatch_tol - scores)
        out.add_site_attribute("bv_sum", bv_ops.bv_sums(
            centers, anions, r0, cell, b=self.b, cutoff=self.cutoff,
            device=self.device))
        if self.verbose:
            logger.info(
                "BondValenceSiteGenerator: %d sites for %s (V=%g) from "
                "%d anions on a %d^3 grid", out.n_sites, cation,
                self.v_ideal, len(anions), self.n_bins)
        return out
