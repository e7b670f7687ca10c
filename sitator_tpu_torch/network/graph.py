"""Graph export: a :class:`SiteNetwork` as a ``networkx`` digraph, and
the conduction-bottleneck readout of its jump graph.

Beyond-reference convenience (the reference keeps its jump graph as
bare ``n_ij`` arrays, SURVEY.md §3.5): hand the analyzed network to the
standard Python graph ecosystem — community detection, centrality,
shortest paths, drawing — without re-assembling attribute arrays by
hand.  Host-side and lazy (networkx imported on call by
:func:`to_networkx` alone; :class:`ConductionBottleneckAnalysis` computes
its betweenness itself, ``network/_brandes.py``).
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["to_networkx", "ConductionBottleneckAnalysis"]


def to_networkx(sn, edge_attr="n_ij", edge_threshold=0.0,
                include_site_attrs=True):
    """Build a ``networkx.DiGraph`` from a site network.

    Nodes are site indices carrying ``center`` (tuple), ``site_type``
    (when typed) and — with ``include_site_attrs`` — every scalar
    per-site attribute (vector-valued attributes are skipped).  A
    directed edge ``i -> j`` is added wherever
    ``edge_attr[i, j] > edge_threshold`` and finite, carrying
    ``weight`` (the attribute value), ``distance`` (minimum-image
    center separation) and every other finite scalar edge attribute at
    that pair.  ``edge_attr=None`` exports nodes only.
    """
    import networkx as nx

    from sitator_tpu_torch.network.compare import min_image_distance_matrix

    g = nx.DiGraph()
    S = sn.n_sites
    centers = np.asarray(sn.centers, dtype=np.float64)
    scalar_site_attrs = {}
    if include_site_attrs:
        for name in sn.site_attributes:
            arr = np.asarray(sn.get_site_attribute(name))
            if arr.shape == (S,):
                scalar_site_attrs[name] = arr
    for i in range(S):
        attrs = {"center": tuple(centers[i])}
        if sn.site_types is not None:
            attrs["site_type"] = int(sn.site_types[i])
        for name, arr in scalar_site_attrs.items():
            attrs[name] = float(arr[i])
        g.add_node(i, **attrs)
    if edge_attr is None:
        return g
    if edge_attr not in sn.edge_attributes:
        raise ValueError(f"network has no edge attribute {edge_attr!r} "
                         f"(have: {sorted(sn.edge_attributes)})")
    w = np.asarray(sn.get_edge_attribute(edge_attr), dtype=np.float64)
    D = min_image_distance_matrix(centers, centers,
                                  sn.structure.cell)
    other = {name: np.asarray(sn.get_edge_attribute(name),
                              dtype=np.float64)
             for name in sn.edge_attributes
             if name != edge_attr
             and np.asarray(sn.get_edge_attribute(name)).shape == (S, S)}
    ii, jj = np.nonzero(np.isfinite(w) & (w > edge_threshold))
    for i, j in zip(ii.tolist(), jj.tolist()):
        if i == j:
            continue
        attrs = {"weight": float(w[i, j]), "distance": float(D[i, j])}
        for name, arr in other.items():
            if np.isfinite(arr[i, j]):
                attrs[name] = float(arr[i, j])
        g.add_edge(i, j, **attrs)
    logger.info("exported %d sites / %d edges (attr %r > %g)",
                S, g.number_of_edges(), edge_attr, edge_threshold)
    return g


class ConductionBottleneckAnalysis:
    """Which sites carry the long-range transport?  (Beyond the
    reference surface — its pathway analysis stops at percolation
    membership, SURVEY.md §3.5.)

    Two complementary readouts on the observed jump graph:

    - ``betweenness_`` — weighted betweenness centrality of every site
      on the rate graph (edge length = 1 / (n_ij + n_ji): busy hops are
      short).  High-betweenness sites funnel the conduction paths.
    - ``critical_sites_`` — of the ``n_candidates`` highest-betweenness
      sites, the ones whose REMOVAL drops the network's periodic
      percolation dimensionality (true conduction bottlenecks: block
      one of these — by doping, occupation, or strain — and long-range
      transport along some direction dies).  ``base_dim_`` /
      ``removal_dims_`` carry the numbers.

    Writes the site attribute ``betweenness``; ``run`` accepts a
    SiteTrajectory (computing ``n_ij`` via JumpAnalysis when missing)
    or a SiteNetwork with ``n_ij``, and returns ``self``.  ``device`` is
    the torch device for those jump tallies (default 'cuda').
    """

    def __init__(self, connectivity_threshold=1, n_candidates=10,
                 verbose=True, device="cuda"):
        self.device = device
        self.connectivity_threshold = int(connectivity_threshold)
        if self.connectivity_threshold < 1:
            # threshold 0 would make EVERY pair an 'edge' (sym >= 0),
            # with 1/0 = inf weights and a vacuously-percolating graph
            raise ValueError("connectivity_threshold must be >= 1 "
                             "(it gates on observed jump counts)")
        self.n_candidates = int(n_candidates)
        self.verbose = verbose

    def run(self, st_or_sn):
        from sitator_tpu_torch.core.sitetraj import SiteTrajectory
        from sitator_tpu_torch.network._brandes import betweenness_centrality
        from sitator_tpu_torch.network.pathways import DiffusionPathwayAnalysis

        if isinstance(st_or_sn, SiteTrajectory):
            sn = st_or_sn.site_network
            if "n_ij" not in sn.edge_attributes:
                from sitator_tpu_torch.dynamics import JumpAnalysis
                JumpAnalysis(verbose=False,
                             device=self.device).run(st_or_sn)
        else:
            sn = st_or_sn
            if "n_ij" not in sn.edge_attributes:
                raise ValueError("SiteNetwork has no n_ij; run "
                                 "JumpAnalysis first")
        S = sn.n_sites
        n_ij = np.asarray(sn.n_ij, dtype=np.float64)
        sym = n_ij + n_ij.T
        np.fill_diagonal(sym, 0.0)
        conn = sym >= self.connectivity_threshold

        ii, jj = np.nonzero(np.triu(conn, k=1))
        self.betweenness_ = betweenness_centrality(S, ii, jj,
                                                   1.0 / sym[ii, jj])
        if "betweenness" in sn.site_attributes:
            sn.remove_attribute("betweenness")
        sn.add_site_attribute("betweenness", self.betweenness_)

        frac = np.asarray(sn.centers) @ np.linalg.inv(
            np.asarray(sn.structure.cell, dtype=np.float64))
        perc = DiffusionPathwayAnalysis.percolation_dimension
        self.base_dim_ = perc(conn, frac)
        order = np.argsort(self.betweenness_)[::-1]
        cands = [int(i) for i in order[: self.n_candidates]
                 if self.betweenness_[i] > 0]
        self.candidates_ = np.asarray(cands, dtype=np.int64)
        dims = []
        critical = []
        for i in cands:
            sub = conn.copy()
            sub[i, :] = False
            sub[:, i] = False
            d = perc(sub, frac)
            dims.append(d)
            if d < self.base_dim_:
                critical.append(i)
        self.removal_dims_ = np.asarray(dims, dtype=np.int32)
        self.critical_sites_ = np.asarray(critical, dtype=np.int64)
        if self.verbose:
            logger.info(
                "conduction bottlenecks: base percolation %dD; "
                "%d/%d top-betweenness sites are critical (%s)",
                self.base_dim_, len(critical), len(cands),
                critical)
        return self
