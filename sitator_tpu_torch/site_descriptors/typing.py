"""``SiteTypeAnalysis`` — unsupervised site typing from descriptors.

Reference parity: ``sitator/site_descriptors/SiteTypeAnalysis.py``
(SURVEY.md §3.6): dimensionality-reduce the per-site descriptor matrix
(PCA) and agglomeratively cluster it, choosing the number of types by the
dissimilarity elbow; writes ``site_types`` onto the ``SiteNetwork``.

The JAX package calls scikit-learn (``PCA``, Ward
``AgglomerativeClustering``); the port computes the same steps itself:
the PCA in float64 on ``device`` (:func:`pca`: the solver sklearn's
``svd_solver='auto'`` picks at the matrix's shape, and its ``svd_flip``
sign rule), the Ward tree on the host with
``scipy.cluster.hierarchy.ward`` (what sklearn's unstructured
``ward_tree`` calls), and the cut at ``k`` types by a copy of sklearn's
``_hc_cut``, so the type numbers are sklearn's own.  The matrices are
small (sites x descriptor width): not a perf path.
"""
from __future__ import annotations

import heapq
import logging

import numpy as np

from sitator_tpu_torch.util.elbow import elbow_index

logger = logging.getLogger(__name__)


def pca(X, n_components, device="cuda"):
    """``sklearn.decomposition.PCA(n_components).fit_transform(X)`` in
    float64 on ``device``; returns a host float64 array.

    sklearn's ``'auto'`` solver takes the covariance's ``eigh`` for a tall
    matrix (at most 1000 columns and at least 10 times as many rows) and
    the SVD of the centred data otherwise (it would take a randomized SVD,
    an approximation of this one, above 500 rows or columns for few
    components).  Each component's sign makes its largest-magnitude
    loading positive (``svd_flip(u_based_decision=False)``)."""
    import torch

    X = torch.as_tensor(np.asarray(X), dtype=torch.float64, device=device)
    n, d = X.shape
    if not 0 <= n_components <= min(n, d):
        raise ValueError(f"n_components={n_components} must be between 0 "
                         f"and min(n_samples, n_features)={min(n, d)}")
    Xc = X - X.mean(dim=0)
    if d <= 1000 and n >= 10 * d:
        evals, evecs = torch.linalg.eigh(Xc.T @ Xc / (n - 1))
        Vt = evecs.flip(1).T
        U = None
    else:
        U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    pick = Vt.abs().argmax(dim=1, keepdim=True)
    signs = torch.sign(Vt.gather(1, pick))
    Vt = Vt * signs
    if U is None:
        reduced = Xc @ Vt[:n_components].T
    else:
        reduced = U[:, :n_components] * signs[:n_components, 0] \
            * S[:n_components]
    return reduced.cpu().numpy()


def ward_tree(X):
    """``(children, distances)`` of the full Ward tree of the rows of
    ``X``, as sklearn's ``ward_tree`` gives them without connectivity:
    merge ``i`` joins ``children[i]`` into node ``n + i``."""
    from scipy.cluster import hierarchy

    Z = hierarchy.ward(np.require(np.asarray(X, dtype=np.float64),
                                  requirements="W"))
    return Z[:, :2].astype(np.intp), Z[:, 2]


def _descendants(node, children, n_leaves):
    if node < n_leaves:
        return [node]
    out, stack = [], [node]
    while stack:
        i = stack.pop()
        if i < n_leaves:
            out.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return out


def hc_cut(n_clusters, children, n_leaves):
    """sklearn's ``_hc_cut``: the labels of ``n_clusters`` clusters cut
    from the tree, numbered in the order of its heap of node ids."""
    if n_clusters > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: "
                         f"{n_clusters} clusters were given for a tree "
                         f"with {n_leaves} leaves.")
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -these[0])
        heapq.heappushpop(nodes, -these[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_descendants(-node, children, n_leaves)] = i
    return label


class SiteTypeAnalysis:
    """Parameters
    ----------
    descriptor : object with ``get_descriptors(st) -> (matrix, counts)``
        (e.g. :class:`SOAPDescriptorAverages`).
    n_components : PCA components (None = min(10, D)).
    max_types : consider 2..max_types clusters for the elbow.
    n_types : force an exact number of types (skips the elbow).
    device : torch device of the PCA (default 'cuda').

    After ``run``: ``descriptor_matrix``, ``reduced`` (the PCA scores,
    float64), and — where a tree was built — ``children_`` and
    ``distances_`` (the Ward tree's merges and merge distances).
    """

    def __init__(self, descriptor, n_components=None, max_types=8,
                 n_types=None, verbose=True, device="cuda"):
        self.descriptor = descriptor
        self.n_components = n_components
        self.max_types = int(max_types)
        self.n_types = n_types
        self.verbose = verbose
        self.device = device
        self.descriptor_matrix = None
        self.reduced = None
        self.children_ = self.distances_ = None

    def run(self, st):
        """st : SiteTrajectory (or anything the descriptor accepts).
        Returns the input with ``site_types`` set on its network."""
        sn = getattr(st, "site_network", st)
        descs, counts = self.descriptor.get_descriptors(st)
        self.descriptor_matrix = descs
        n_sites = len(descs)

        n_comp = self.n_components
        if n_comp is None:
            n_comp = min(10, descs.shape[1], max(1, n_sites - 1))
        n_comp = min(n_comp, n_sites)
        self.reduced = pca(descs, n_comp, self.device)
        self.children_ = self.distances_ = None

        def tree():
            if self.children_ is None:
                self.children_, self.distances_ = ward_tree(self.reduced)
            return self.children_

        if self.n_types is not None:
            k = int(self.n_types)
        else:
            # dissimilarity elbow over candidate cluster counts: use the
            # agglomerative merge distances; pick the elbow of the curve
            kmax = min(self.max_types, n_sites)
            if kmax < 2:
                k = 1
            else:
                tree()
                # last (kmax-1) merge distances, largest = fewest clusters
                d = self.distances_[-(kmax - 1):][::-1]  # k=2.. merge costs
                # curve of "cost of going from k+1 to k clusters"
                k = int(2 + elbow_index(d))
        k = max(1, min(k, n_sites))

        labels = (np.zeros(n_sites, dtype=np.int32) if k == 1 else
                  hc_cut(k, tree(), n_sites).astype(np.int32))
        sn.site_types = labels
        if self.verbose:
            logger.info("SiteTypeAnalysis: %d site types over %d sites",
                        k, n_sites)
        return st
