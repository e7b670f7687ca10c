"""Weighted betweenness centrality of an undirected graph (Brandes), on the
host in NumPy/SciPy — what ``networkx.betweenness_centrality(G,
weight=...)`` computes for ``ConductionBottleneckAnalysis``, without
``networkx``.

For each source: Dijkstra distances (``scipy.sparse.csgraph.dijkstra``,
which forms ``dist[v] + w`` and keeps the strict minimum as networkx's
Dijkstra does, so both reach the same floats); then networkx's tie rule —
``v`` precedes its neighbour ``w`` on a shortest path exactly when
``dist[v] + w(v, w) == dist[w]`` — counts the shortest paths ``sigma`` in
order of distance and accumulates the dependencies ``delta`` back in the
reverse order (``delta[v] += sigma[v] * (1 + delta[w]) / sigma[w]`` over
the successors ``w``).  A block of sources goes through each step
together: step ``r`` handles every source's ``r``-th nearest node.  Only
the order of the floating-point sums differs from networkx's.
Normalisation is networkx's for an undirected graph without endpoints:
``1 / ((n - 1)(n - 2))`` for ``n > 2``, none below.
"""
from __future__ import annotations

import numpy as np

__all__ = ["betweenness_centrality"]

# float64 elements of each (sources x nodes) work array
_BLOCK_ELEMS = 1 << 22


def betweenness_centrality(n, rows, cols, weights):
    """Normalised weighted betweenness of the ``n`` nodes of the undirected
    graph with edges ``rows[e] -- cols[e]`` of length ``weights[e] > 0``
    (each pair once).  Returns a float64 array of length ``n``."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    n = int(n)
    bc = np.zeros(n, np.float64)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    w = np.asarray(weights, np.float64)
    if n < 3 or rows.size == 0:
        return bc
    g = csr_matrix((np.concatenate([w, w]),
                    (np.concatenate([rows, cols]),
                     np.concatenate([cols, rows]))), shape=(n, n))
    deg = np.diff(g.indptr)
    width = int(deg.max())
    # padded neighbour lists; a pad points at the node itself with an
    # infinite length, which never satisfies the tie rule
    slot = np.arange(width)[None, :]
    valid = slot < deg[:, None]
    at = np.minimum(g.indptr[:-1, None] + slot, g.indptr[-1] - 1)
    nbr = np.where(valid, g.indices[at], np.arange(n)[:, None])
    nlen = np.where(valid, g.data[at], np.inf)

    step = max(1, min(n, _BLOCK_ELEMS // n))
    for lo in range(0, n, step):
        src = np.arange(lo, min(lo + step, n))
        bc += _dependencies(g, src, nbr, nlen, dijkstra).sum(axis=0)
    return bc * (1.0 / ((n - 1) * (n - 2)))


def _dependencies(g, src, nbr, nlen, dijkstra):
    """``delta[s, v]``: the dependency of each source on every node (0 at
    the source itself and at nodes it cannot reach)."""
    m, n = len(src), g.shape[0]
    dist = dijkstra(g, directed=True, indices=src)
    order = np.argsort(dist, axis=1, kind="stable")
    r_ = np.arange(m)[:, None]
    reached = np.isfinite(dist)
    sigma = np.zeros((m, n))
    sigma[np.arange(m), src] = 1.0
    n_reached = reached.sum(axis=1)

    def around(v):
        """The neighbours of the nodes ``v[s]`` of each source, and which
        of them precede (``dist[nb] + len == dist[v]``) and follow
        (``dist[v] + len == dist[nb]``) ``v`` on a shortest path."""
        nb = nbr[v]
        dv = dist[r_[:, 0], v][:, None]
        dn = dist[r_, nb]
        return (nb, (dn + nlen[v] == dv) & (dn < dv),
                (dv + nlen[v] == dn) & (dv < dn))

    last = int(n_reached.max())
    for r in range(1, last):
        v = order[:, r]
        nb, pred, _ = around(v)
        sigma[r_[:, 0], v] = np.where(
            r < n_reached, (sigma[r_, nb] * pred).sum(axis=1), 0.0)
    delta = np.zeros((m, n))
    coeff = np.zeros((m, n))       # (1 + delta[w]) / sigma[w]
    for r in range(last - 1, 0, -1):
        v = order[:, r]
        live = r < n_reached
        nb, _, succ = around(v)
        s_v = np.where(live, sigma[r_[:, 0], v], 1.0)
        d_v = np.where(live, (s_v[:, None] * coeff[r_, nb] * succ).sum(
            axis=1), 0.0)
        delta[r_[:, 0], v] = d_v
        coeff[r_[:, 0], v] = np.where(live, (1.0 + d_v) / s_v, 0.0)
    return delta
