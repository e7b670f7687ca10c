"""``DiffusionPathwayAnalysis`` — connected diffusion pathways and their
periodic percolation dimensionality.

Reference parity: ``sitator/network/DiffusionPathwayAnalysis.py`` (SURVEY.md
§3.5): threshold the ``n_ij`` jump graph, find connected components
(candidate pathways), decide whether each percolates through the periodic
boundaries, and with what dimensionality (0–3).

Percolation detection: BFS assigns every site a lattice-image offset; an
edge closing a loop with a *mismatched* offset exposes a lattice vector
along which the pathway wraps the cell.  The rank of the span of all such
wrap vectors is the pathway's dimensionality.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory

logger = logging.getLogger(__name__)


class DiffusionPathwayAnalysis:
    """Parameters
    ----------
    connectivity_threshold : minimum ``n_ij + n_ji`` on an edge for it to
        count as connected (default 1 — any observed jump).
    minimum_n_sites : pathways with fewer sites than this get id −1.
    device : torch device for the jump tallies when ``n_ij`` has to be
        computed from a SiteTrajectory (default 'cuda').
    """

    NO_PATHWAY = -1

    def __init__(self, connectivity_threshold=1, minimum_n_sites=0,
                 verbose=True, device="cuda"):
        self.connectivity_threshold = connectivity_threshold
        self.device = device
        self.minimum_n_sites = int(minimum_n_sites)
        self.verbose = verbose
        self.n_pathways = None
        self.pathway_dims = None
        self.pathway_percolating = None

    def run(self, st_or_sn):
        """Accepts a SiteTrajectory (uses / computes its network's ``n_ij``)
        or a SiteNetwork with ``n_ij`` present.  Writes site attribute
        ``diffusion_pathway`` and returns the input."""
        if isinstance(st_or_sn, SiteTrajectory):
            sn = st_or_sn.site_network
            if "n_ij" not in sn.edge_attributes:
                from sitator_tpu_torch.dynamics import JumpAnalysis
                JumpAnalysis(verbose=False,
                             device=self.device).run(st_or_sn)
        else:
            sn = st_or_sn
            if "n_ij" not in sn.edge_attributes:
                raise ValueError("SiteNetwork has no n_ij; run JumpAnalysis")

        S = sn.n_sites
        n_ij = np.asarray(sn.n_ij)
        conn = (n_ij + n_ij.T) >= self.connectivity_threshold
        np.fill_diagonal(conn, False)

        frac = sn.centers @ np.linalg.inv(sn.structure.cell)

        pathway = np.full(S, self.NO_PATHWAY, dtype=np.int32)
        dims = []
        percolating = []
        next_id = 0
        for root in range(S):
            if pathway[root] != self.NO_PATHWAY or not conn[root].any():
                continue
            members, wrap_vecs = self._bfs_component(root, conn, frac)
            if len(members) < self.minimum_n_sites:
                continue
            pathway[members] = next_id
            dim = self._wrap_rank(wrap_vecs)
            dims.append(int(dim))
            percolating.append(dim > 0)
            next_id += 1

        self.n_pathways = next_id
        self.pathway_dims = np.array(dims, dtype=np.int32)
        self.pathway_percolating = np.array(percolating, dtype=bool)
        if "diffusion_pathway" in sn.site_attributes:
            sn.remove_attribute("diffusion_pathway")
        sn.add_site_attribute("diffusion_pathway", pathway)
        if self.verbose:
            logger.info(
                "DiffusionPathwayAnalysis: %d pathways; dims %s",
                next_id, dims)
        return st_or_sn

    @staticmethod
    def percolation_dimension(conn, frac):
        """Maximum periodic-percolation dimensionality over the
        connected components of a boolean adjacency ``conn (S, S)``
        with fractional centers ``frac`` — the reusable core of
        :meth:`run` (consumed by
        :class:`~sitator_tpu_torch.network.graph.ConductionBottleneckAnalysis`
        for removal experiments)."""
        S = conn.shape[0]
        seen = np.zeros(S, dtype=bool)
        best = 0
        for root in range(S):
            if seen[root] or not conn[root].any():
                continue
            members, wraps = DiffusionPathwayAnalysis._bfs_component(
                root, conn, frac)
            seen[members] = True
            best = max(best,
                       DiffusionPathwayAnalysis._wrap_rank(wraps))
        return best

    @staticmethod
    def _wrap_rank(wrap_vecs):
        """Percolation dimensionality of one component: the rank of
        the span of its integer lattice wrap vectors — the single
        authority shared by :meth:`run` and
        :meth:`percolation_dimension`."""
        if not wrap_vecs:
            return 0
        W = np.array(wrap_vecs, dtype=np.float64)
        return int(np.linalg.matrix_rank(np.round(W), tol=1e-6))

    @staticmethod
    def _bfs_component(root, conn, frac):
        """BFS with image-offset bookkeeping.  Returns (member indices,
        list of integer lattice wrap vectors discovered)."""
        offsets = {root: np.zeros(3)}
        queue = [root]
        wraps = []
        while queue:
            i = queue.pop()
            for j in np.flatnonzero(conn[i]):
                # integer image shift of the minimum-image i->j connection
                d = frac[j] - frac[i]
                shift = -np.round(d)
                oj = offsets[i] + shift
                if j in offsets:
                    mismatch = offsets[j] - oj
                    if np.any(np.abs(mismatch) > 1e-9):
                        wraps.append(mismatch)
                else:
                    offsets[j] = oj
                    queue.append(j)
        members = np.array(sorted(offsets), dtype=np.int64)
        # dedupe wrap vectors up to sign, keeping the first of each (they
        # are integer-valued: differences of sums of rounded shifts)
        uniq, seen = [], set()
        for w in wraps:
            key = tuple(int(x) for x in np.round(w))
            if key not in seen:
                seen.update((key, tuple(-x for x in key)))
                uniq.append(w)
        return members, uniq
