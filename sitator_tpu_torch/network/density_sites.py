"""Site seeding from time-averaged mobile-ion density —
``DensitySiteGenerator``.

Beyond the reference surface (upstream ``sitator`` seeds sites only via
the Zeo++ Voronoi decomposition of the empty lattice, SURVEY.md §3.3):
the complementary, trajectory-driven route used throughout the
superionic-conductor literature — accumulate the mobile-ion density on
a periodic grid, smooth, and take the basin maxima as candidate sites.
Finds exactly the *occupied* basins (including interstitial sites a
geometric decomposition misses) and none of the never-visited nodes, at
the price of needing a trajectory.  The grid accumulation runs on
device (:mod:`sitator_tpu_torch.ops.density`); everything downstream is a
once-per-trajectory host pass.

The produced network carries ``vertices`` (the ``n_vertices`` nearest
static atoms of each center, minimum-image) so it drops straight into
:class:`~sitator_tpu_torch.landmark.analysis.LandmarkAnalysis` as a landmark
basis, plus the site attribute ``site_density`` (each site's smoothed
peak density, a proxy for relative occupancy).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork
from sitator_tpu_torch.network.compare import min_image_distance_matrix
from sitator_tpu_torch.ops import density as density_ops

__all__ = ["DensitySiteGenerator"]

logger = logging.getLogger(__name__)


class DensitySiteGenerator:
    """``run(sn_without_sites, traj) -> SiteNetwork`` whose centers are
    the smoothed mobile-ion density maxima of the trajectory.

    Parameters
    ----------
    n_bins : grid resolution per axis (fractional space).  The implied
        bin width should comfortably resolve ``min_distance``.
    sigma : Gaussian smoothing width in length units (isotropic in
        cartesian space; per-axis widths derived from the cell heights).
    threshold : peaks below ``threshold × max(smoothed density)`` are
        discarded — noise floor for rarely-visited regions.
    min_distance : merge peaks closer than this (minimum image),
        strongest wins.
    n_vertices : static atoms attached to each site as its landmark
        vertex set (nearest by minimum image).
    chunk : frames per device scatter-add dispatch.
    stride : count every ``stride``-th frame only — an unbiased
        whole-run subsample for long trajectories (the sweep stays
        chunked/out-of-core either way).
    device : where the density grid is accumulated (default ``"cuda"``).
    """

    def __init__(self, n_bins=48, sigma=0.5, threshold=0.05,
                 min_distance=1.0, n_vertices=8, chunk=2048,
                 stride=1, verbose=True, device="cuda"):
        if not 0.0 <= threshold < 1.0:
            raise ValueError("threshold must be in [0, 1)")
        if n_vertices < 1:
            raise ValueError("n_vertices must be at least 1")
        self.n_bins = int(n_bins)
        self.sigma = float(sigma)
        self.threshold = float(threshold)
        self.min_distance = float(min_distance)
        self.n_vertices = int(n_vertices)
        self.chunk = int(chunk)
        self.stride = int(stride)
        self.verbose = verbose
        self.device = device

    def run(self, sn: SiteNetwork, traj) -> SiteNetwork:
        """``traj`` may be an in-memory ``(F, N, 3)`` array or any
        sliceable trajectory reader (``NpyTrajectory``,
        ``TensorstoreTrajectory``, ...) — the density pass is chunked
        and never materializes the trajectory."""
        cell = np.asarray(sn.structure.cell, dtype=np.float64)
        grid = density_ops.density_grid(
            traj, cell, mask=sn.mobile_mask, n_bins=self.n_bins,
            chunk=self.chunk, stride=self.stride, device=self.device)
        smoothed = density_ops.smooth_density(grid, cell, self.sigma)
        centers, weights = density_ops.find_density_peaks(
            smoothed, cell, threshold_rel=self.threshold,
            min_distance=self.min_distance)
        if len(centers) == 0:
            raise ValueError(
                "no density peaks found — lower threshold/sigma or "
                "check the mobile selection")

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = centers
        static_idx = np.flatnonzero(sn.static_mask).astype(np.int32)
        if len(static_idx):
            k = min(self.n_vertices, len(static_idx))
            static_pos = sn.structure.positions[static_idx]
            D = min_image_distance_matrix(centers, static_pos, cell)
            nearest = np.argsort(D, axis=1)[:, :k]
            out.vertices = [static_idx[row] for row in nearest]
        out.add_site_attribute("site_density", weights)
        if self.verbose:
            logger.info(
                "DensitySiteGenerator: %d sites from a %d^3 grid over "
                "%d frames (max count %d)", out.n_sites, self.n_bins,
                len(traj), int(grid.max()))
        return out
