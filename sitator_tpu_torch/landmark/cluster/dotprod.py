"""Default landmark clustering backend: dot-product agglomeration
(counterpart of ``sitator_tpu.landmark.cluster.dotprod``).

Fitting runs on a strided subsample capped at ``fit_max_samples``;
prediction runs over the full sample set in device-sized blocks.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from sitator_tpu_torch.ops.cluster import dotprod_fit
from sitator_tpu_torch.ops.landmark import assign_to_centers

logger = logging.getLogger(__name__)

DEFAULT_PARAMS = {
    "clustering_threshold": 0.45,
    "assignment_threshold": 0.35,
    "k_max": 512,
    "n_refine_iters": 10,
    "fit_max_samples": 131072,
    "predict_block": 65536,
}


def do_landmark_clustering(landmark_vectors, clustering_params, min_samples,
                           verbose=False, device="cuda"):
    """Cluster row-normalised ``landmark_vectors (n_samples, n_landmarks)``
    (host array) on ``device``.  Returns ``(counts, assignments,
    confidences, centers)`` as NumPy: compact labels ``0..K-1`` (``-1`` =
    unassigned) and the unit centres ``(K, n_landmarks)`` of the clusters
    holding at least ``min_samples`` samples."""
    p = {**DEFAULT_PARAMS, **(clustering_params or {})}
    lv = np.asarray(landmark_vectors, dtype=np.float32)
    n = len(lv)

    # fit on an evenly-strided subsample (temporally uniform coverage)
    stride = max(1, int(np.ceil(n / p["fit_max_samples"])))
    fit_X = torch.from_numpy(np.ascontiguousarray(lv[::stride])).to(device)
    # min_samples applies to the full set; scale to the subsample
    fit_min = max(1, int(min_samples / stride))
    res = dotprod_fit(fit_X, k_max=p["k_max"],
                      cluster_threshold=p["clustering_threshold"],
                      min_samples=fit_min, n_iters=p["n_refine_iters"])
    del fit_X
    if verbose:
        logger.info("dotprod clustering: %d clusters from %d fit samples "
                    "(stride %d)", res.n_clusters, -(-n // stride), stride)
    if res.n_clusters >= p["k_max"]:
        logger.warning("dotprod clustering hit k_max=%d; raise k_max",
                       p["k_max"])

    centers = res["centers"]
    active = res["active"]

    labels = np.empty(n, dtype=np.int32)
    confs = np.empty(n, dtype=np.float32)
    B = p["predict_block"]
    for lo in range(0, n, B):
        blk = torch.from_numpy(lv[lo:lo + B]).to(device)
        lab, cf = assign_to_centers(blk, centers, active,
                                    p["assignment_threshold"])
        labels[lo:lo + B] = lab.cpu().numpy()
        confs[lo:lo + B] = cf.cpu().numpy()

    # enforce min_samples on full-set counts, then compact labels
    k_max = centers.shape[0]
    counts_full = np.bincount(labels[labels >= 0], minlength=k_max)
    active_np = active.cpu().numpy() & (counts_full >= min_samples)
    remap = np.full(k_max, -1, dtype=np.int32)
    kept = np.flatnonzero(active_np)
    remap[kept] = np.arange(len(kept))
    ok = labels >= 0
    labels[ok] = remap[labels[ok]]
    # confidences stay the raw max cosine similarity for every sample,
    # assigned or not (unassigned is signalled by label -1 alone)
    counts = np.bincount(labels[labels >= 0], minlength=len(kept))
    return counts, labels, confs, centers.cpu().numpy()[kept]
