"""``NAvgsPerSite`` — n representative averaged positions per site.

Reference parity: ``sitator/misc/NAvgsPerSite.py`` (SURVEY.md §3.8 ⚠): for
descriptor sampling, replace each site by ``n`` averaged positions drawn
from its assigned real-space point cloud.  Returns an expanded
``SiteNetwork`` whose sites are the averages; site attribute
``source_site`` maps each back to its original site.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory
from sitator_tpu_torch.ops.pbc import PBCCalculator


class NAvgsPerSite:
    """Parameters
    ----------
    n : averages per site.
    error_on_insufficient : raise if a site has fewer than ``n`` assigned
        points (else that site contributes fewer averages).
    weighted : weight averages by assignment confidence.
    """

    def __init__(self, n, error_on_insufficient=False, weighted=True,
                 verbose=True):
        self.n = int(n)
        self.error_on_insufficient = bool(error_on_insufficient)
        self.weighted = bool(weighted)
        self.verbose = verbose

    def run(self, st: SiteTrajectory) -> SiteNetwork:
        sn = st.site_network
        calc = PBCCalculator(sn.structure.cell)
        centers = []
        source = []
        for site in range(sn.n_sites):
            pts, confs = st.real_positions_for_site(
                site, return_confidences=True)
            if len(pts) < self.n:
                if self.error_on_insufficient:
                    raise ValueError(
                        f"site {site} has {len(pts)} < n={self.n} points")
                groups = [np.arange(len(pts))] if len(pts) else []
            else:
                # round-robin split preserves temporal spread per group
                groups = [np.arange(g, len(pts), self.n)
                          for g in range(self.n)]
            for g in groups:
                w = confs[g] if self.weighted else None
                centers.append(calc.average(pts[g], w))
                source.append(site)

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = np.asarray(centers).reshape(-1, 3)
        out.add_site_attribute("source_site",
                               np.asarray(source, dtype=np.int32))
        if sn.site_types is not None:
            out.site_types = sn.site_types[np.asarray(source)]
        return out
