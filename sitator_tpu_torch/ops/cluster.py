"""Threshold-based cosine clustering (counterpart of
``sitator_tpu.ops.cluster``): the number of clusters is discovered.

- seeding: greedily add the first still-uncovered sample as a centre,
  keeping a running max-similarity per sample (one ``X @ c`` per round);
- refinement: fixed-iteration Lloyd passes — threshold-gated arg-max
  assignment, one-hot ``Wᵀ @ X`` recentring, renormalisation;
- a static ``k_max`` with an ``active`` mask.

Samples are expected row-normalised (cosine == dot product).
"""
from __future__ import annotations

import torch

__all__ = ["dotprod_fit", "dotprod_refine", "ClusterResult"]


def _seed(X, valid, k_max, cluster_threshold):
    """Greedy seeding; returns ``(centers (k_max, D), k)``."""
    n, d = X.shape
    centers = torch.zeros((k_max, d), dtype=X.dtype, device=X.device)
    # invalid samples count as covered, so they never seed
    max_sim = torch.where(valid, -torch.inf, torch.inf).to(X.dtype)
    k = 0
    while k < k_max:
        uncovered = max_sim < cluster_threshold
        if not bool(uncovered.any()):
            break
        # first sample not yet covered by any centre (deterministic order)
        seed_idx = int(uncovered.to(torch.int8).argmax())
        c = X[seed_idx]
        centers[k] = c
        sims = X @ c
        # the seed is covered by fiat: a sub-unit row's self-similarity can
        # sit below the threshold forever and would re-seed it until k_max
        sims[seed_idx] = torch.inf
        max_sim = torch.maximum(max_sim, sims)
        k += 1
    return centers, k


def dotprod_refine(X, centers, k, k_max, cluster_threshold, n_iters=10):
    """Lloyd-style refinement: threshold-gated arg-max assignment, one-hot
    matmul recentre, renormalise.  Empty clusters keep their old centre.
    Returns (centers, counts of the last pass)."""
    slot_active = torch.arange(k_max, device=X.device) < k
    counts = torch.zeros(k_max, dtype=X.dtype, device=X.device)
    for _ in range(n_iters):
        sims = torch.where(slot_active[None, :], X @ centers.T, -torch.inf)
        conf = sims.amax(dim=1)
        label = sims.argmax(dim=1)
        w = torch.nn.functional.one_hot(label, k_max).to(X.dtype)
        w = w * (conf >= cluster_threshold)[:, None]
        counts = w.sum(dim=0)                                 # (K,)
        newc = w.T @ X                                        # (K, D)
        norms = torch.sqrt((newc * newc).sum(dim=1, keepdim=True))
        newc = newc / torch.clamp_min(norms, 1e-12)
        centers = torch.where((counts > 0)[:, None], newc, centers)
    return centers, counts


class ClusterResult(dict):
    """centers (K_max, D), active (K_max,), counts (K_max,), n_clusters."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def dotprod_fit(X, k_max, cluster_threshold, min_samples=1, n_iters=10,
                valid=None):
    """Fit threshold-based cosine clusters on row-normalised ``X (n, D)``.

    ``valid`` masks samples eligible to seed.  Regardless of it, samples
    whose row norm is below ``cluster_threshold`` never seed: ``sim(x, c) ≤
    |x|`` for unit centres, so no centre can ever cover them.
    """
    coverable = (X * X).sum(dim=1) >= cluster_threshold ** 2
    valid = coverable if valid is None else (valid & coverable)
    centers, k = _seed(X, valid, k_max, cluster_threshold)
    centers, counts = dotprod_refine(X, centers, k, k_max, cluster_threshold,
                                     n_iters=n_iters)
    active = (torch.arange(k_max, device=X.device) < k) \
        & (counts >= min_samples)
    return ClusterResult(centers=centers, active=active, counts=counts,
                         n_clusters=int(active.sum()))
