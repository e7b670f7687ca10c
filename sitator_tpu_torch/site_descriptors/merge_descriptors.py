"""``MergeSitesByDescriptors`` — merge sites with matching environments.

Counterpart of ``sitator_tpu.site_descriptors.merge_descriptors``
(``MergeSitesByDescriptors``, SURVEY.md §3.4): sites whose (SOAP) descriptors are more similar than a
threshold are single-linkage grouped and merged, guarded by the base
class's distance/site-type checks.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.network.merging import MergeSitesBase, _components


class MergeSitesByDescriptors(MergeSitesBase):
    """Parameters
    ----------
    descriptor : object with ``get_descriptors(st) -> (matrix, counts)``.
    similarity_threshold : cosine similarity above which two sites'
        environments count as the same (default 0.98).
    distance_threshold : geometric guard from the base (default 3.0 Å).
    """

    def __init__(self, descriptor, similarity_threshold=0.98,
                 distance_threshold=3.0, **kwargs):
        super().__init__(distance_threshold=distance_threshold, **kwargs)
        self.descriptor = descriptor
        self.similarity_threshold = float(similarity_threshold)

    def _get_merges(self, st):
        descs, _ = self.descriptor.get_descriptors(st)
        d = np.asarray(descs, dtype=np.float64)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        sims = d @ d.T
        adj = sims >= self.similarity_threshold
        np.fill_diagonal(adj, False)
        return _components(adj)
