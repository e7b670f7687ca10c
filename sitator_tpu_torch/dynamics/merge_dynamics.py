"""``MergeSitesByDynamics`` — fix over-splitting using the jump graph
(counterpart of ``sitator_tpu.dynamics.merge_dynamics``).

Fast back-and-forth hopping between two "sites" means they are
one physical site: build a transition matrix from ``n_ij`` (+ self loops),
run Markov Clustering (matrix products on the device,
:mod:`sitator_tpu_torch.ops.mcl`), and
merge each strongly-connected group, guarded by ``distance_threshold`` and
same-``site_type`` checks (handled by :class:`MergeSitesBase`).
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis
from sitator_tpu_torch.network.merging import MergeSitesBase
from sitator_tpu_torch.ops.mcl import markov_cluster


class MergeSitesByDynamics(MergeSitesBase):
    """Parameters
    ----------
    inflation : MCL inflation exponent — higher = finer clusters.
    self_loop : diagonal weight added before normalization.  'auto'
        (default) uses each node's max edge weight — this keeps MCL from
        oscillating on strongly-coupled site pairs (the exact structures
        this merger exists to find); a float gives a uniform loop weight.
    max_iters, prune : MCL iteration controls.
    distance_threshold : refuse merges beyond this distance (Å); default 3.0.
    device : torch device for the jump tallies and MCL (default 'cuda').
    """

    def __init__(self, inflation=2.0, self_loop="auto", max_iters=100,
                 prune=1e-6, distance_threshold=3.0, device="cuda",
                 **kwargs):
        super().__init__(distance_threshold=distance_threshold, **kwargs)
        self.inflation = float(inflation)
        self.self_loop = self_loop if self_loop == "auto" else float(self_loop)
        self.max_iters = int(max_iters)
        self.prune = float(prune)
        self.device = device

    def _get_merges(self, st):
        sn = st.site_network
        if "n_ij" not in sn.edge_attributes:
            JumpAnalysis(verbose=False, device=self.device).run(st)
        n_ij = np.asarray(sn.n_ij, dtype=np.float64)
        # undirected transition graph + self loops
        T = n_ij + n_ij.T
        if self.self_loop == "auto":
            loops = np.maximum(T.max(axis=1), 1.0)
        else:
            loops = self.self_loop
        T[np.diag_indices_from(T)] += loops
        return markov_cluster(T, inflation=self.inflation,
                              max_iters=self.max_iters, prune=self.prune,
                              device=self.device)
