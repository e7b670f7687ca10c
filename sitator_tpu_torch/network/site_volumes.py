"""``SiteVolumes`` — per-site occupied volume estimates.

Reference parity: ``SiteVolumes`` (SURVEY.md §2 layer L5 ⚠): the volume of
real space a site's assigned point cloud occupies — the convex hull of the
(minimum-image unified) member positions — plus its surface area.  Written
as site attributes ``site_volumes`` / ``site_surface_areas`` (NaN for sites
with fewer than 4 non-degenerate points).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.ops.pbc import PBCCalculator

logger = logging.getLogger(__name__)


class SiteVolumes:
    """Parameters
    ----------
    error_on_insufficient : raise when a site has < 4 points (else NaN).
    """

    def __init__(self, error_on_insufficient=False, verbose=True):
        self.error_on_insufficient = bool(error_on_insufficient)
        self.verbose = verbose

    def run(self, st):
        from scipy.spatial import ConvexHull, QhullError

        sn = st.site_network
        calc = PBCCalculator(sn.structure.cell)
        vols = np.full(sn.n_sites, np.nan)
        areas = np.full(sn.n_sites, np.nan)
        for site in range(sn.n_sites):
            pts = st.real_positions_for_site(site)
            if len(pts) < 4:
                if self.error_on_insufficient:
                    raise ValueError(
                        f"site {site} has {len(pts)} < 4 assigned points")
                continue
            pts = calc.min_image(sn.centers[site], pts)
            try:
                hull = ConvexHull(pts)
            except QhullError:
                if self.error_on_insufficient:
                    raise
                continue
            vols[site] = hull.volume
            areas[site] = hull.area
        for name in ("site_volumes", "site_surface_areas"):
            if name in sn.site_attributes:
                sn.remove_attribute(name)
        sn.add_site_attribute("site_volumes", vols)
        sn.add_site_attribute("site_surface_areas", areas)
        if self.verbose:
            logger.info("SiteVolumes: mean volume %.3f A^3 over %d sites",
                        np.nanmean(vols), sn.n_sites)
        return st
