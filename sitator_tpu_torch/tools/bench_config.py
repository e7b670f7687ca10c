"""The 10k-atom bench configuration of the system (NumPy only): a simple
cubic host lattice of ``N_CELLS``^3 = 9261 static atoms with lattice
constant ``A_LAT``, one site at the centre of every cube with its 8 corner
atoms as vertices (what ``VoronoiSiteGenerator`` finds on this lattice,
built directly), ``N_IONS`` = 739 mobile ions on randomly chosen sites
(10,000 atoms in all) and ``K_CENTERS`` = 1024 random unit centres.

The port's own copy of the reference's bench geometry: the same constants
and, for a seed, the same arrays, draw for draw.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

N_CELLS = 21          # 21^3 = 9261 static atoms
A_LAT = 4.0
N_IONS = 739          # 9261 + 739 = 10000 atoms
K_CENTERS = 1024

__all__ = ["N_CELLS", "A_LAT", "N_IONS", "K_CENTERS", "BenchSystem",
           "build_system"]


class BenchSystem(NamedTuple):
    """``cell`` (3, 3) float32; ``verts`` (n_static, 8) int32, site ``s``'s
    corner atoms; ``frames(n, seed)`` → (static (n, n_static, 3), mobile
    (n, n_ions, 3)) float32, thermal jitter of 0.05 Å on the lattice and
    0.25 Å about the ions' sites; ``centers`` (k_centers, n_static) random
    positive unit rows, float32; ``host`` and ``sites`` (n_static, 3) the
    lattice and the site positions; ``occ`` (n_ions,) the ions' sites."""
    cell: np.ndarray
    verts: np.ndarray
    frames: Callable
    centers: np.ndarray
    n_static: int
    host: np.ndarray
    sites: np.ndarray
    occ: np.ndarray


def build_system(seed=0, *, n_cells=N_CELLS, n_ions=N_IONS,
                 k_centers=K_CENTERS, a_lat=A_LAT):
    """The bench system for ``seed`` (smaller with the keyword sizes)."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    n_static = len(grid)
    host = grid * a_lat
    cell = np.eye(3, dtype=np.float32) * (n_cells * a_lat)
    verts = np.zeros((n_static, 8), np.int32)
    k = 0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                gi = (grid[:, 0] + di) % n_cells
                gj = (grid[:, 1] + dj) % n_cells
                gk = (grid[:, 2] + dk) % n_cells
                verts[:, k] = (gi * n_cells + gj) * n_cells + gk
                k += 1
    sites = (grid + 0.5) * a_lat
    occ = rng.choice(n_static, size=n_ions, replace=False)

    def frames(n, seed2):
        r = np.random.default_rng(seed2)
        static = host[None] + r.normal(scale=0.05, size=(n, n_static, 3))
        mobile = sites[occ][None] + r.normal(scale=0.25, size=(n, n_ions, 3))
        return static.astype(np.float32), mobile.astype(np.float32)

    centers = rng.random((k_centers, n_static)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return BenchSystem(cell, verts, frames, centers, n_static, host, sites,
                       occ)
