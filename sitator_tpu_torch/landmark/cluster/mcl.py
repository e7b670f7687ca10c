"""MCL landmark clustering backend (counterpart of
``sitator_tpu.landmark.cluster.mcl``).

Clusters a subsample's cosine similarity graph with Markov Clustering on
the device, takes normalised member means as centres, and predicts the full
set with the usual cosine assignment.  Same module-level protocol as
:mod:`.dotprod`.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from sitator_tpu_torch.ops.landmark import assign_to_centers
from sitator_tpu_torch.ops.mcl import markov_cluster

logger = logging.getLogger(__name__)

DEFAULT_PARAMS = {
    "similarity_threshold": 0.45,   # graph edge cutoff (cosine)
    "assignment_threshold": 0.35,
    "inflation": 1.6,
    "max_samples": 4096,            # MCL is O(n^3) in the sample graph
    "predict_block": 65536,
}


def do_landmark_clustering(landmark_vectors, clustering_params, min_samples,
                           verbose=False, device="cuda"):
    p = {**DEFAULT_PARAMS, **(clustering_params or {})}
    lv = np.asarray(landmark_vectors, dtype=np.float32)
    n = len(lv)
    stride = max(1, int(np.ceil(n / p["max_samples"])))
    X = lv[::stride]
    X = X[np.linalg.norm(X, axis=1) > 0]

    sims = X @ X.T
    adj = np.where(sims >= p["similarity_threshold"], sims, 0.0)
    groups = markov_cluster(adj, inflation=p["inflation"], device=device)
    centers = []
    for g in groups:
        if len(g) < max(1, min_samples // stride):
            continue
        c = X[g].mean(axis=0)
        nrm = np.linalg.norm(c)
        if nrm > 0:
            centers.append(c / nrm)
    centers = (np.stack(centers) if centers
               else np.zeros((0, lv.shape[1]), np.float32))
    if verbose:
        logger.info("mcl clustering: %d clusters from %d fit samples",
                    len(centers), len(X))
    if len(centers) == 0:
        return (np.zeros(0, np.int64), np.full(n, -1, np.int32),
                np.zeros(n, np.float32), centers)

    labels = np.empty(n, dtype=np.int32)
    confs = np.empty(n, dtype=np.float32)
    ct = torch.from_numpy(centers).to(device)
    act = torch.ones(len(centers), dtype=torch.bool, device=device)
    B = p["predict_block"]
    for lo in range(0, n, B):
        lab, cf = assign_to_centers(torch.from_numpy(lv[lo:lo + B]).to(device),
                                    ct, act, p["assignment_threshold"])
        labels[lo:lo + B] = lab.cpu().numpy()
        confs[lo:lo + B] = cf.cpu().numpy()

    counts_full = np.bincount(labels[labels >= 0], minlength=len(centers))
    keep = counts_full >= min_samples
    remap = np.full(len(centers), -1, np.int32)
    remap[keep] = np.arange(keep.sum())
    ok = labels >= 0
    labels[ok] = remap[labels[ok]]
    counts = np.bincount(labels[labels >= 0], minlength=int(keep.sum()))
    return counts, labels, confs, centers[keep]
