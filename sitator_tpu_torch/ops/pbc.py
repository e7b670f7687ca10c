"""Periodic-boundary-condition math (counterpart of ``sitator_tpu.ops.pbc``).

Only what the landmark → assign → jump path calls is here: the
minimum-image displacement on tensors, and :class:`PBCCalculator`, the
host-side float64 NumPy class, copied because ``sitator_tpu.ops`` cannot be
imported without JAX.

Conventions: ``cell`` is a ``(3, 3)`` matrix whose **rows** are the lattice
vectors (cartesian = fractional @ cell); minimum images use fractional
rounding, with an optional 27-image search for pathologically skewed cells.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_frac", "to_cart", "min_image_disp", "PBCCalculator"]


def to_frac(x, cell_inv):
    """Cartesian → fractional coordinates. ``x``: (..., 3)."""
    return x @ cell_inv


def to_cart(f, cell):
    """Fractional → cartesian coordinates. ``f``: (..., 3)."""
    return f @ cell


def min_image_disp(dx, cell, cell_inv, exact: bool = False):
    """Minimum-image displacement vector(s) for cartesian ``dx (..., 3)``."""
    df = to_frac(dx, cell_inv)
    df = df - torch.round(df)
    d = to_cart(df, cell)
    if not exact:
        return d
    r = torch.tensor([-1.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    shifts = torch.cartesian_prod(r, r, r) @ cell            # (27, 3)
    cand = d[..., None, :] + shifts                          # (..., 27, 3)
    best = (cand * cand).sum(-1).argmin(-1)
    return torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]


class PBCCalculator:
    """Host-side float64 PBC math with the reference's API surface
    (``distances``, ``min_image``, ``wrap_points``, ``average``,
    ``to_cell_coords``, ``to_real_coords``, ``is_in_image_of``).  Pure
    NumPy: it serves host-side bookkeeping where double precision matters
    and arrays are tiny."""

    def __init__(self, cell, exact: bool = False):
        self.cell = np.asarray(cell, dtype=np.float64)
        if self.cell.shape != (3, 3):
            raise ValueError("cell must be (3, 3); rows are lattice vectors")
        self.cell_inv = np.linalg.inv(self.cell)
        self.exact = bool(exact)
        if exact:
            self._shifts = np.array(
                [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1)], dtype=np.float64) @ self.cell

    def _min_image_disp(self, dx):
        df = dx @ self.cell_inv
        df -= np.round(df)
        d = df @ self.cell
        if not self.exact:
            return d
        cand = d[..., None, :] + self._shifts  # (..., 27, 3)
        norms = np.einsum("...ki,...ki->...k", cand, cand)
        best = np.argmin(norms, axis=-1)
        return np.take_along_axis(cand, best[..., None, None],
                                  axis=-2)[..., 0, :]

    # -- distances ---------------------------------------------------------
    def distances(self, pt, pts):
        """Min-image distance(s) from ``pt`` (3,) or (n,3) to ``pts`` (n, 3)."""
        pt = np.asarray(pt, dtype=np.float64)
        pts = np.asarray(pts, dtype=np.float64)
        d = self._min_image_disp(pts - pt)
        return np.sqrt(np.sum(d * d, axis=-1))

    def pairwise_distances(self, a, b=None):
        a = np.asarray(a, dtype=np.float64)
        b = a if b is None else np.asarray(b, dtype=np.float64)
        d = self._min_image_disp(a[:, None, :] - b[None, :, :])
        return np.sqrt(np.sum(d * d, axis=-1))

    def paired_distances(self, a, b):
        """Row-wise min-image distances |b[i] - a[i]| for (n, 3) arrays."""
        d = self._min_image_disp(np.asarray(b, np.float64)
                                 - np.asarray(a, np.float64))
        return np.sqrt(np.sum(d * d, axis=-1))

    # -- images / wrapping -------------------------------------------------
    def min_image(self, ref, pts):
        """Map ``pts`` into the minimum image of ``ref``; returns new array."""
        ref = np.asarray(ref, dtype=np.float64)
        pts = np.asarray(pts, dtype=np.float64)
        return ref + self._min_image_disp(pts - ref)

    def wrap_points(self, pts):
        f = np.asarray(pts, dtype=np.float64) @ self.cell_inv
        f -= np.floor(f)
        return f @ self.cell

    def is_in_image_of(self, pt, ref, tol=1e-5):
        """True if ``pt`` is a periodic image of ``ref`` (within ``tol``)."""
        d = self.distances(np.asarray(ref), np.asarray(pt)[None, :])
        return bool(d[0] < tol)

    # -- coordinates -------------------------------------------------------
    def to_cell_coords(self, pts):
        return np.asarray(pts, dtype=np.float64) @ self.cell_inv

    def to_real_coords(self, frac):
        return np.asarray(frac, dtype=np.float64) @ self.cell

    # -- averaging ---------------------------------------------------------
    def average(self, points, weights=None):
        """PBC-aware (weighted) mean: members mapped into the image of the
        highest-weight member before the mean; result wrapped home."""
        points = np.asarray(points, dtype=np.float64)
        w = (np.ones(len(points)) if weights is None
             else np.asarray(weights, dtype=np.float64))
        ref = points[int(np.argmax(w))]
        disp = self._min_image_disp(points - ref)
        mean = ref + (disp * w[:, None]).sum(0) / max(w.sum(), 1e-300)
        return self.wrap_points(mean)
