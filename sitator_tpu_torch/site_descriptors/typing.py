"""``SiteTypeAnalysis`` — unsupervised site typing from descriptors.

Reference parity: ``sitator/site_descriptors/SiteTypeAnalysis.py``
(SURVEY.md §3.6): dimensionality-reduce the per-site descriptor matrix
(PCA) and agglomeratively cluster it, choosing the number of types by the
dissimilarity elbow; writes ``site_types`` onto the ``SiteNetwork``.
Host-side sklearn — tiny matrices, not a perf path.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.util.elbow import elbow_index

logger = logging.getLogger(__name__)


class SiteTypeAnalysis:
    """Parameters
    ----------
    descriptor : object with ``get_descriptors(st) -> (matrix, counts)``
        (e.g. :class:`SOAPDescriptorAverages`).
    n_components : PCA components (None = min(10, D)).
    max_types : consider 2..max_types clusters for the elbow.
    n_types : force an exact number of types (skips the elbow).
    """

    def __init__(self, descriptor, n_components=None, max_types=8,
                 n_types=None, verbose=True):
        self.descriptor = descriptor
        self.n_components = n_components
        self.max_types = int(max_types)
        self.n_types = n_types
        self.verbose = verbose
        self.descriptor_matrix = None
        self.reduced = None

    def run(self, st):
        """st : SiteTrajectory (or anything the descriptor accepts).
        Returns the input with ``site_types`` set on its network."""
        from sklearn.cluster import AgglomerativeClustering
        from sklearn.decomposition import PCA

        sn = getattr(st, "site_network", st)
        descs, counts = self.descriptor.get_descriptors(st)
        self.descriptor_matrix = descs
        n_sites = len(descs)

        n_comp = self.n_components
        if n_comp is None:
            n_comp = min(10, descs.shape[1], max(1, n_sites - 1))
        n_comp = min(n_comp, n_sites)
        self.reduced = PCA(n_components=n_comp).fit_transform(descs)

        if self.n_types is not None:
            k = int(self.n_types)
        else:
            # dissimilarity elbow over candidate cluster counts: use the
            # agglomerative merge distances; pick the elbow of the curve
            kmax = min(self.max_types, n_sites)
            if kmax < 2:
                k = 1
            else:
                agg = AgglomerativeClustering(
                    n_clusters=None, distance_threshold=0.0,
                    compute_full_tree=True)
                agg.fit(self.reduced)
                # last (kmax-1) merge distances, largest = fewest clusters
                d = agg.distances_[-(kmax - 1):][::-1]  # k=2.. merge costs
                # curve of "cost of going from k+1 to k clusters"
                k = int(2 + elbow_index(d))
        k = max(1, min(k, n_sites))

        labels = (np.zeros(n_sites, dtype=np.int32) if k == 1 else
                  AgglomerativeClustering(n_clusters=k).fit_predict(
                      self.reduced).astype(np.int32))
        sn.site_types = labels
        if self.verbose:
            logger.info("SiteTypeAnalysis: %d site types over %d sites",
                        k, n_sites)
        return st
