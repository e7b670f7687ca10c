"""``DotProdClassifier`` — a fit/predict object over the device clustering
(counterpart of ``sitator_tpu.util.dotprod``), for users porting scripts
written against the classifier API.
"""
from __future__ import annotations

import numpy as np
import torch

from sitator_tpu_torch.ops.cluster import dotprod_fit
from sitator_tpu_torch.ops.landmark import assign_to_centers


class DotProdClassifier:
    """Parameters
    ----------
    threshold : cosine similarity above which a sample joins a cluster
        during fitting.
    max_converge_iters : Lloyd refinement iterations.
    min_samples : drop clusters smaller than this after fitting.
    k_max : static capacity for discovered clusters.
    device : torch device the fit and the prediction run on (default
        'cuda').
    """

    def __init__(self, threshold=0.9, max_converge_iters=10, min_samples=1,
                 k_max=512, device="cuda"):
        self.threshold = float(threshold)
        self.max_converge_iters = int(max_converge_iters)
        self.min_samples = int(min_samples)
        self.k_max = int(k_max)
        self.device = torch.device(device)
        self._centers = None
        self._active = None

    @staticmethod
    def _normalize(X):
        X = np.asarray(X, dtype=np.float32)
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        return X / np.maximum(norms, 1e-12)

    def fit(self, X):
        Xn = self._normalize(X)
        res = dotprod_fit(torch.from_numpy(Xn).to(self.device),
                          k_max=self.k_max,
                          cluster_threshold=self.threshold,
                          min_samples=self.min_samples,
                          n_iters=self.max_converge_iters)
        keep = res["active"].cpu().numpy()
        self._centers = res["centers"].cpu().numpy()[keep]
        self._active = np.ones(len(self._centers), dtype=bool)
        return self

    @property
    def n_clusters(self):
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        return len(self._centers)

    @property
    def cluster_centers(self):
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        return self._centers

    def predict(self, X, threshold=None, return_confidences=False):
        """Labels (−1 below ``threshold``; defaults to the fit threshold)."""
        if self._centers is None:
            raise ValueError("classifier has not been fit")
        thr = self.threshold if threshold is None else float(threshold)
        Xn = self._normalize(X)
        labels, confs = assign_to_centers(
            torch.from_numpy(Xn).to(self.device),
            torch.from_numpy(self._centers).to(self.device),
            torch.from_numpy(self._active).to(self.device), thr)
        if return_confidences:
            return labels.cpu().numpy(), confs.cpu().numpy()
        return labels.cpu().numpy()

    def fit_predict(self, X, predict_threshold=None,
                    return_confidences=False):
        self.fit(X)
        return self.predict(X, threshold=predict_threshold,
                            return_confidences=return_confidences)
