"""Abstract site-merging machinery (the MergeSites framework).

Reference parity: the merge-base shared by ``MergeSitesByDynamics``,
``MergeSitesByDistance`` and ``MergeSitesByDescriptors`` (SURVEY.md §3.4 /
§3.5 ⚠ on exact file split).  Subclasses implement ``_get_merges(st) ->
groups``; the base handles everything mechanical: sanity guards
(``distance_threshold``, same-``site_type``), occupancy-weighted PBC centers,
vertex-set unions, trajectory relabeling, and attribute remapping.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.core.sitetraj import SiteTrajectory
from sitator_tpu_torch.ops.pbc import PBCCalculator

logger = logging.getLogger(__name__)


class MergeSitesBase:
    """Configure in ctor, ``run(st) -> SiteTrajectory`` (reference calling
    convention).

    Parameters
    ----------
    distance_threshold : refuse to merge sites farther apart than this (Å);
        ``None`` disables the guard.
    check_types : if the network has ``site_types``, only merge sites of the
        same type.
    """

    def __init__(self, distance_threshold=None, check_types=True,
                 verbose=True):
        self.distance_threshold = distance_threshold
        self.check_types = bool(check_types)
        self.verbose = verbose

    # -- subclass interface -------------------------------------------------
    def _get_merges(self, st: SiteTrajectory):
        """Return an iterable of site-index groups to merge.  Groups need not
        cover all sites; uncovered sites stay as singletons."""
        raise NotImplementedError

    # -- machinery ----------------------------------------------------------
    def run(self, st: SiteTrajectory) -> SiteTrajectory:
        sn = st.site_network
        S = sn.n_sites
        calc = PBCCalculator(sn.structure.cell)
        groups = [np.asarray(g, dtype=np.int64) for g in self._get_merges(st)]

        # split groups that violate the guards
        groups = self._apply_guards(groups, sn, calc)

        # complete to a partition
        covered = np.zeros(S, dtype=bool)
        for g in groups:
            if covered[g].any():
                raise ValueError("merge groups overlap")
            covered[g] = True
        final = [g for g in groups]
        final += [np.array([i]) for i in np.flatnonzero(~covered)]
        # stable order: by smallest member index
        final.sort(key=lambda g: int(g.min()))

        occ = self._occupancy_counts(st, S)
        new_centers = np.empty((len(final), 3))
        new_vertices = None
        if sn.has_vertices:
            new_vertices = []
        new_types = None if sn.site_types is None else np.empty(
            len(final), dtype=np.int32)
        for k, g in enumerate(final):
            w = occ[g].astype(np.float64)
            if w.sum() == 0:
                w = np.ones(len(g))
            new_centers[k] = calc.average(sn.centers[g], w)
            if new_vertices is not None:
                new_vertices.append(np.unique(np.concatenate(
                    [sn.vertices[i] for i in g])))
            if new_types is not None:
                new_types[k] = sn.site_types[g[np.argmax(w)]]

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = new_centers
        if new_vertices is not None:
            out.vertices = new_vertices
        if new_types is not None:
            out.site_types = new_types

        remap = np.full(S, -1, dtype=np.int32)
        for k, g in enumerate(final):
            remap[g] = k
        traj = st.traj.copy()
        ok = traj >= 0
        traj[ok] = remap[traj[ok]]
        st2 = SiteTrajectory(out, traj, st.confidences)
        if st.real_trajectory is not None:
            st2.set_real_traj(st.real_trajectory)
        st2.compute_site_occupancies()
        if self.verbose:
            n_merged = sum(1 for g in final if len(g) > 1)
            logger.info("%s: %d sites -> %d (%d merge groups)",
                        type(self).__name__, S, len(final), n_merged)
        return st2

    def _apply_guards(self, groups, sn, calc):
        out = []
        for g in groups:
            for sub in self._split_group(g, sn, calc):
                if len(sub):
                    out.append(sub)
        return [g for g in out if len(g) > 1] + \
               [g for g in out if len(g) == 1]

    def _split_group(self, g, sn, calc):
        if len(g) <= 1:
            return [g]
        subs = [g]
        if self.check_types and sn.site_types is not None:
            subs = [g[sn.site_types[g] == t]
                    for t in np.unique(sn.site_types[g])]
        if self.distance_threshold is None:
            return subs
        final = []
        for sub in subs:
            # greedy split: single-linkage components under the threshold
            if len(sub) <= 1:
                final.append(sub)
                continue
            d = calc.pairwise_distances(sn.centers[sub])
            adj = d <= self.distance_threshold
            final.extend(sub[c] for c in _components(adj))
        return final

    @staticmethod
    def _occupancy_counts(st, S):
        t = st.traj
        return np.bincount(t[t >= 0].ravel(), minlength=S)


def _components(adj):
    """Connected components of a boolean adjacency matrix → index arrays."""
    n = len(adj)
    seen = np.zeros(n, dtype=bool)
    comps = []
    for i in range(n):
        if seen[i]:
            continue
        stack = [i]
        seen[i] = True
        comp = []
        while stack:
            j = stack.pop()
            comp.append(j)
            nbrs = np.flatnonzero(adj[j] & ~seen)
            seen[nbrs] = True
            stack.extend(nbrs.tolist())
        comps.append(np.sort(np.array(comp)))
    return comps


class MergeSitesByDistance(MergeSitesBase):
    """Merge sites by single-linkage agglomeration on PBC distances
    (reference ``MergeSitesByDistance`` parity).

    ``threshold`` is the linkage distance (Å)."""

    def __init__(self, threshold, **kwargs):
        kwargs.setdefault("distance_threshold", None)
        super().__init__(**kwargs)
        self.threshold = float(threshold)

    def _get_merges(self, st):
        sn = st.site_network
        calc = PBCCalculator(sn.structure.cell)
        d = calc.pairwise_distances(sn.centers)
        return _components(d <= self.threshold)
