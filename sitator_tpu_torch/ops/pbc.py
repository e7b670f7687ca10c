"""Periodic-boundary-condition math (counterpart of ``sitator_tpu.ops.pbc``).

Functional tensor ops (the cell is passed explicitly; shapes broadcast) for
device code, and :class:`PBCCalculator`, the host-side float64 NumPy class
that the merging, seeding and network modules use.

Conventions: ``cell`` is a ``(3, 3)`` matrix whose **rows** are the lattice
vectors (cartesian = fractional @ cell); minimum images use fractional
rounding, with an optional 27-image search for pathologically skewed cells.
PBC-aware averaging maps points into the image nearest a reference member
before the weighted mean.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cell_inverse",
    "to_frac",
    "to_cart",
    "wrap_frac",
    "wrap",
    "min_image_disp",
    "pbc_distance",
    "pairwise_pbc_distances",
    "pbc_average",
    "masked_pbc_average",
    "rescale_to_cell",
    "PBCCalculator",
]


def cell_inverse(cell):
    """Inverse of the cell matrix (fractional = cartesian @ cell_inv)."""
    return torch.linalg.inv(cell)


def to_frac(x, cell_inv):
    """Cartesian → fractional coordinates. ``x``: (..., 3)."""
    return x @ cell_inv


def to_cart(f, cell):
    """Fractional → cartesian coordinates. ``f``: (..., 3)."""
    return f @ cell


def wrap_frac(f):
    """Wrap fractional coords into [0, 1)."""
    return f - torch.floor(f)


def wrap(x, cell, cell_inv):
    """Wrap cartesian points into the home cell."""
    return to_cart(wrap_frac(to_frac(x, cell_inv)), cell)


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


def pbc_distance(a, b, cell, cell_inv, exact: bool = False):
    """Minimum-image distance |b - a| with broadcasting over leading dims."""
    d = min_image_disp(b - a, cell, cell_inv, exact=exact)
    return torch.sqrt((d * d).sum(-1))


def pairwise_pbc_distances(a, b, cell, cell_inv, exact: bool = False):
    """All-pairs minimum-image distances.  a: (n, 3), b: (m, 3) → (n, m)."""
    d = min_image_disp(a[:, None, :] - b[None, :, :], cell, cell_inv,
                       exact=exact)
    return torch.sqrt((d * d).sum(-1))


def _average_about(points, w, cell, cell_inv, ref):
    disp = min_image_disp(points - ref, cell, cell_inv)
    mean = ref + (disp * w[..., None]).sum(0) / w.sum().clamp_min(1e-30)
    return wrap(mean, cell, cell_inv)


def pbc_average(points, cell, cell_inv, weights=None, ref=None):
    """PBC-aware (weighted) mean of ``points`` (n, 3).

    Maps every point into the minimum image of a reference point (by default
    the highest-weight member, falling back to the first point) before taking
    the weighted mean, then wraps the result into the home cell.  Correct
    whenever the point cloud is clustered within half a cell — true by
    construction for site-member point clouds.
    """
    if weights is None:
        w = torch.ones(points.shape[:-1], dtype=points.dtype,
                       device=points.device)
    else:
        w = torch.as_tensor(weights, dtype=points.dtype, device=points.device)
    if ref is None:
        ref = points[torch.argmax(w)]
    return _average_about(points, w, cell, cell_inv, ref)


def masked_pbc_average(points, mask, cell, cell_inv, weights=None):
    """PBC mean over ``points`` (n, 3) where ``mask`` (n,) selects members:
    the fixed-shape variant (masked rows weigh nothing).  The reference
    point is the highest-(masked-)weight member."""
    w = mask.to(points.dtype)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=points.dtype,
                            device=points.device) * w
    return _average_about(points, w, cell, cell_inv, points[torch.argmax(w)])


def rescale_to_cell(positions, cells, ref_cell, origins=None, ref_origin=None):
    """Affine, fractional-preserving map of per-frame positions into one
    reference cell — the variable-cell (NPT) → fixed-cell data-model bridge.

    Frame ``t`` goes through ``frac = (pos_t - origin_t) @ inv(cell_t)`` and
    back out through ``frac @ ref_cell + ref_origin``: fractional
    coordinates are preserved exactly, so sites (which live in fractional
    space for homogeneous cell fluctuations) become stationary in the
    reference cell.  **No wrapping** is applied — unwrapped (continuous)
    coordinates stay continuous, which downstream min-image math handles.

    Host-side NumPy float64 by design: this runs at the IO boundary, once
    per frame, on data that is about to be staged to the device anyway.

    positions: (F, A, 3) (or (A, 3)); cells: (F, 3, 3) (or (3, 3));
    ref_cell: (3, 3); origins: optional (F, 3) per-frame box origins;
    ref_origin: optional (3,).  Returns positions mapped into ``ref_cell``,
    same shape, float64.
    """
    pos = np.asarray(positions, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.float64)
    ref_cell = np.asarray(ref_cell, dtype=np.float64)
    squeeze = pos.ndim == 2
    if squeeze:
        pos = pos[None]
    if cells.ndim == 2:
        cells = np.broadcast_to(cells, (pos.shape[0], 3, 3))
    if origins is not None:
        org = np.atleast_2d(np.asarray(origins, dtype=np.float64))
        pos = pos - org[:, None, :]
    frac = np.einsum("fai,fij->faj", pos, np.linalg.inv(cells))
    out = frac @ ref_cell
    if ref_origin is not None:
        out = out + np.asarray(ref_origin, dtype=np.float64)
    return out[0] if squeeze else out


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
