"""Occupancy density grids on the device + host peak extraction
(counterpart of ``sitator_tpu.ops.density``).

Time-averaged mobile-ion density is the second way to seed sites, beside
the Voronoi decomposition of the static lattice: sites are where the ions
actually are.  It needs a trajectory but finds exactly the occupied basins.

The grid accumulation is the hot part (O(F·M)) and runs on ``device``:
fractional coordinates, ``floor`` to bin triplets, one integer
``torch.bincount`` per frame chunk (integer atomic adds, so the counts do
not depend on the order of arrival), accumulated on the host in int64.
Smoothing and peak finding run once on the host in float64: a periodic
Gaussian filter in fractional space (per-axis widths from the cell heights,
so ``sigma`` is in length units even for triclinic cells), 26-neighbour
local maxima, sub-bin refinement by a periodic centre of mass over the 3³
neighbourhood, and greedy minimum-image non-maximum suppression.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["density_grid", "smooth_density", "find_density_peaks"]

# one chunk's counts must stay within exact-int32 territory (the reference's
# chunk arithmetic, kept so both packages cut a trajectory the same way)
_MAX_CHUNK_POINTS = 2 ** 31 - 2 ** 24


def _grid_chunk(pos, cell_inv, n_bins):
    """Bin a ``(C, M, 3)`` float32 cartesian chunk into a flat
    ``(n_bins³,)`` int64 periodic histogram.

    The fractional coordinates are three explicit float32 multiply-adds a
    component, not a matrix product: a reduced-precision product mode (TF32)
    would move seam-adjacent atoms a whole bin and break the exact-count
    contract, and no library precision setting reaches elementwise code."""
    p = pos.reshape(-1, 3)
    frac = (p[:, 0:1] * cell_inv[0] + p[:, 1:2] * cell_inv[1]
            + p[:, 2:3] * cell_inv[2])
    frac = frac - torch.floor(frac)                   # wrap into [0, 1)
    idx = (frac * n_bins).to(torch.int32).clamp_(0, n_bins - 1).long()
    flat = (idx[:, 0] * n_bins + idx[:, 1]) * n_bins + idx[:, 2]
    return torch.bincount(flat, minlength=n_bins ** 3)


def density_grid(traj, cell, mask=None, n_bins=48, chunk=2048, stride=1,
                 device="cuda"):
    """Periodic occupancy histogram of the selected atoms over the whole
    trajectory: ``(n_bins, n_bins, n_bins)`` int64 counts in fractional
    space (bin ``[i,j,k]`` covers fractional ``[i/n, (i+1)/n)`` etc.).
    ``stride`` counts every ``stride``-th frame only — an unbiased
    whole-run subsample for seeding from long trajectories (reads stay
    chunked; skipped frames in a chunk are fetched but not binned).

    ``traj`` is ``(F, N, 3)`` cartesian (wrapped or not — coordinates
    are wrapped into the cell here): an in-memory array OR any sliceable
    trajectory reader (``len()`` + ``reader[lo:hi] -> (C, N, 3)``, e.g.
    ``ArrayTrajectory``) — readers are swept chunkwise without ever
    materializing the trajectory.  ``mask`` selects the atoms to count
    (default: all).  Integer counts per chunk on ``device``, host
    accumulation in int64.
    """
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
    F = len(traj)
    probe = np.asarray(traj[0:1])
    M = int(mask.sum()) if mask is not None else probe.shape[1]
    if M == 0:
        raise ValueError("density_grid: no atoms selected")
    if n_bins < 2:
        raise ValueError("n_bins must be at least 2")
    stride = int(stride)
    if stride < 1:
        raise ValueError("stride must be at least 1")
    device = torch.device(device)
    cell_inv = torch.as_tensor(
        np.linalg.inv(np.asarray(cell, dtype=np.float64)).astype(
            np.float32), device=device)
    chunk = max(1, min(int(chunk), _MAX_CHUNK_POINTS // M))
    # chunk boundaries on stride multiples keep the global subsample
    # (frames 0, stride, 2·stride, ...) aligned across chunks
    chunk = max(stride, (chunk // stride) * stride)
    grid = np.zeros(n_bins ** 3, dtype=np.int64)
    counted = 0
    for lo in range(0, F, chunk):
        part = np.asarray(traj[lo:lo + chunk])[::stride]
        if mask is not None:
            part = part[:, mask, :]
        counted += part.shape[0]
        part = torch.as_tensor(part.astype(np.float32), device=device)
        grid += _grid_chunk(part, cell_inv, n_bins).cpu().numpy()
    assert counted == len(range(0, F, stride))
    assert grid.sum() == counted * M                 # nothing dropped
    return grid.reshape(n_bins, n_bins, n_bins)


def _cell_heights(cell):
    """Perpendicular distance between opposite faces, per axis."""
    cell = np.asarray(cell, dtype=np.float64)
    vol = abs(np.linalg.det(cell))
    return np.array([vol / np.linalg.norm(
        np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        for i in range(3)])


def smooth_density(grid, cell, sigma):
    """Periodic Gaussian smoothing of a fractional-space grid with an
    isotropic real-space width ``sigma`` (length units): per-axis bin
    widths come from the cell heights, so skewed cells smooth
    isotropically in cartesian space (to first order)."""
    from scipy.ndimage import gaussian_filter
    grid = np.asarray(grid, dtype=np.float64)
    heights = _cell_heights(cell)
    sig_bins = [float(sigma) / (h / n)
                for h, n in zip(heights, grid.shape)]
    return gaussian_filter(grid, sigma=sig_bins, mode="wrap")


def find_density_peaks(smoothed, cell, threshold_rel=0.05,
                       min_distance=1.0):
    """Local maxima of a periodic density grid → cartesian centers.

    A bin is a peak when it is ≥ all 26 periodic neighbors and above
    ``threshold_rel × max``.  Each peak is refined to sub-bin accuracy
    by the center of mass of its (background-subtracted) 3³
    neighborhood, then peaks closer than ``min_distance`` (minimum
    image) are merged greedily, strongest first.

    Returns ``(centers, weights)``: ``(P, 3)`` cartesian positions and
    the smoothed density at each surviving peak, strongest first.
    """
    from sitator_tpu_torch.network.compare import min_image_distance_matrix
    g = np.asarray(smoothed, dtype=np.float64)
    n = g.shape
    is_max = np.ones(n, dtype=bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == dj == dk == 0:
                    continue
                is_max &= g >= np.roll(g, (di, dj, dk), axis=(0, 1, 2))
    thr = threshold_rel * g.max()
    peaks = np.argwhere(is_max & (g > thr))
    if len(peaks) == 0:
        return np.zeros((0, 3)), np.zeros(0)
    vals = g[tuple(peaks.T)]
    order = np.argsort(vals)[::-1]
    peaks, vals = peaks[order], vals[order]

    # sub-bin refinement: periodic CoM of the 3^3 neighborhood, with
    # the neighborhood's own floor subtracted so the flat background
    # does not drag the estimate toward the bin center
    offs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.float64)
    nbr_idx = (peaks[:, None, :] + offs[None].astype(np.int64))
    nbr_idx = nbr_idx % np.array(n)
    w = g[nbr_idx[..., 0], nbr_idx[..., 1], nbr_idx[..., 2]]
    w = w - w.min(axis=1, keepdims=True)
    denom = np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    shift = (w[..., None] * offs[None]).sum(axis=1) / denom
    frac = (peaks + 0.5 + shift) / np.array(n)
    cart = frac @ np.asarray(cell, dtype=np.float64)

    # greedy minimum-image non-maximum suppression, strongest first
    D = min_image_distance_matrix(cart, cart, cell)
    keep = []
    for i in range(len(cart)):
        if all(D[i, j] >= min_distance for j in keep):
            keep.append(i)
    return cart[keep], vals[keep]
