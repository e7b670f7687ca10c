"""Markov Clustering (MCL) as a matrix iteration on the device (counterpart
of ``sitator_tpu.ops.mcl``).

Used by ``MergeSitesByDynamics``, the ``mcl`` clustering backend and
``StreamingLandmarkAnalysis.merge_network``.  The expansion step is a dense
``(S, S)`` float32 matrix product (``torch.matmul``; the reference's is a
plain product too, outside any hand-written kernel); inflation, pruning and
column normalisation are elementwise tensor code.  The convergence test
reads one scalar back per iteration, which at these sizes (a few thousand
sites at most) costs less than the product.  Cluster extraction from the
converged (idempotent) matrix is a small host-side pass.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["mcl_iterate", "markov_cluster"]


def _normalize_cols(m):
    return m / m.sum(dim=0, keepdim=True).clamp_min(1e-30)


def mcl_iterate(T, inflation, expansion=2, max_iters=100, prune=1e-6,
                tol=1e-8):
    """Iterate MCL (expand → inflate → prune → renormalise) to convergence.

    ``T`` is a non-negative (S, S) float32 tensor; it is column-normalised
    first.  Returns the converged matrix on ``T``'s device
    (:func:`_mcl_loop` also returns the number of iterations taken)."""
    return _mcl_loop(T, inflation, expansion, max_iters, prune, tol)[0]


def _mcl_loop(T, inflation, expansion=2, max_iters=100, prune=1e-6,
              tol=1e-8):
    """(converged matrix, iterations) of :func:`mcl_iterate`.

    The loop tests ``i < max_iters and max|m − prev| > tol`` before each
    iteration with ``prev = +inf`` at the start, as the reference does.  The
    product must be full float32: on a CUDA tensor with TF32 matrix products
    enabled (``torch.backends.cuda.matmul.allow_tf32``) this raises instead
    of changing the caller's global setting."""
    if T.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "mcl_iterate needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    m = _normalize_cols(T.to(torch.float32))
    prev = torch.full_like(m, float("inf"))
    i = 0
    while i < max_iters and (m - prev).abs().max().item() > tol:
        prev = m
        # expansion = matrix power m**expansion (NOT repeated squaring,
        # which would give m**(2**(expansion-1)) for expansion > 2)
        for _ in range(expansion - 1):
            m = m @ prev
        m = m.clamp_min(0.0).pow(inflation)
        m = torch.where(m < prune, 0.0, m)
        m = _normalize_cols(m)
        i += 1
    return m, i


def markov_cluster(T, inflation=2.0, expansion=2, max_iters=100,
                   prune=1e-6, device="cuda"):
    """Run MCL on ``device`` and extract clusters.

    Returns a list of int arrays — the node groups (covering all S nodes;
    singleton groups included).  Nodes attracted to multiple attractors join
    their first (lowest-index) attractor, making the output a partition.
    """
    T = torch.as_tensor(np.asarray(T), dtype=torch.float32,
                        device=torch.device(device))
    m = mcl_iterate(T, float(inflation), expansion=expansion,
                    max_iters=max_iters, prune=prune).cpu().numpy()
    S = m.shape[0]
    # attractors: rows with significant mass (classic MCL extraction)
    attractors = np.flatnonzero(m.max(axis=1) > 1e-4)
    assigned = np.full(S, -1, dtype=np.int64)
    groups = []
    for a in attractors:
        members = np.flatnonzero(m[a] > 1e-4)
        members = members[assigned[members] < 0]
        if len(members) == 0:
            continue
        assigned[members] = len(groups)
        groups.append(members)
    # orphans (numerically lost mass) become singletons
    for i in np.flatnonzero(assigned < 0):
        assigned[i] = len(groups)
        groups.append(np.array([i]))
    return groups
