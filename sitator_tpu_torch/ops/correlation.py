"""Pair-correlation histograms on the device: RDF and van Hove functions
(counterpart of ``sitator_tpu.ops.correlation``).

- :func:`rdf`: the radial distribution function g(r) between two atom
  selections, frame-averaged.
- :func:`van_hove_distinct`: G_d(r, t) — the probability (relative to
  ideal gas) of finding a *different* ion at distance r after lag t;
  its t→∞ limit is g(r), and filling of the r→0 hole is the classic
  signature of correlated site exchange.
- :func:`van_hove_self` (host): P(r, t) = 4πr²G_s — the distribution of
  single-ion displacement magnitudes after lag t; hop-length peaks make
  discrete jump diffusion visible.

Device mapping: a chunk of ``C`` paired frames is one batched
``(C, Na, Nb)`` minimum-image distance block followed by a fixed-bin
``torch.bincount`` with an overflow bucket, in int64 on ``device``; the
chunks' counts are summed on the device and copied to the host once.
The minimum image is :func:`~sitator_tpu_torch.ops.pbc.min_image_disp`'s
arithmetic (cartesian difference → fractional → subtract the rounded
fraction → cartesian) written out as explicit float32 multiply-adds, one
component at a time, instead of two ``(…, 3) @ (3, 3)`` products, and
the root is taken in float64 and rounded to float32 (torch's float32
``sqrt`` on the CPU is not correctly rounded).  That makes every pair's
distance independent of the chunk's shape and of any reduced-precision
product mode (TF32), so the integer counts do not depend on the
chunking, and a CUDA tensor and a CPU tensor give the same bits: every
step is one correctly rounded IEEE operation, as in a NumPy float32
replica of the same steps.  With ``exact=True``
the 27 neighbouring images are swept in a loop that keeps the smallest
squared norm — 27× the arithmetic of the plain route, no 27× memory.

Chunks are sized by bytes (:data:`_CHUNK_BYTES` of temporaries, about
:data:`_PAIR_BYTES` a pair), not by the reference's int32-carry cap: the
counts here are int64, and that cap (2³¹ pairs) would need ~170 GB of
temporaries.  The self part is a cheap O(N·F) host pass in float64 over
the unwrapped trajectory (the precision reasoning of
:mod:`sitator_tpu_torch.ops.msd`).

Minimum-image validity: ``r_max`` may not exceed half the shortest cell
height (the single-round-trip guarantee); with ``exact=True`` the
27-image exact minimum distance extends validity to the full height.

Histograms are held to the reference as "equal except for at most the
number of pairs within a few float32 ulps of a bin edge": a distance that
close to an edge can land in the neighbouring bin under any other
float32 evaluation order.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from sitator_tpu_torch.ops.msd import unwrap_trajectory

__all__ = ["rdf", "van_hove_distinct", "van_hove_self"]

# temporaries of one chunk: about 80 bytes a pair (the three displacement
# and three fractional components and the running product in float32, the
# squared distance and its float64 root, the int64 bin index, the masks)
_PAIR_BYTES = 80
_CHUNK_BYTES = 2 ** 31


def _dot3(x, m, j):
    """``(x @ m)[..., j]`` for ``x`` a list of three component tensors and
    ``m`` a nested list of float32 values, as three float32 products summed
    left to right."""
    out = x[0] * m[0][j]
    out += x[1] * m[1][j]
    out += x[2] * m[2][j]
    return out


def _image_shifts(cell32):
    """The 27 neighbouring lattice translations ``(27, 3)`` in float32,
    summed left to right as :func:`_dot3` would."""
    n = np.array(list(itertools.product((-1, 0, 1), repeat=3)), np.float32)
    return (n[:, 0:1] * cell32[0] + n[:, 1:2] * cell32[1]
            + n[:, 2:3] * cell32[2])


def _pair_sq_dists(fa, fb, cell, cell_inv, shifts=None):
    """Squared minimum-image distances ``(C, Na, Nb)`` between the rows of
    ``fa (C, Na, 3)`` and ``fb (C, Nb, 3)``: ``pbc.min_image_disp`` of the
    difference ``a − b``, one component at a time (``cell``/``cell_inv`` as
    nested lists of float32 values).  With ``shifts`` (from
    :func:`_image_shifts`) the smallest over the 27 images."""
    dx = [fa[:, :, None, k] - fb[:, None, :, k] for k in range(3)]
    df = [_dot3(dx, cell_inv, j) for j in range(3)]
    del dx
    for f in df:
        f -= torch.round(f)
    d = [_dot3(df, cell, k) for k in range(3)]
    del df
    best = None
    for s in ([(0.0, 0.0, 0.0)] if shifts is None else shifts.tolist()):
        sq = None
        for k in range(3):
            c = d[k] + s[k]
            c *= c
            sq = c if sq is None else sq.add_(c)
        best = sq if best is None else torch.minimum(best, sq, out=best)
    return best


def _pair_hist_chunk(fa, fb, keep, cell, cell_inv, r_max, n_bins,
                     shifts=None):
    """Summed pair-distance histogram of paired frame stacks
    ``(C, Na, 3) × (C, Nb, 3)`` → int64 ``(n_bins,)`` on their device.
    ``keep`` is the ``(Na, Nb)`` bool matrix of pairs to count (False for
    the same atom under two overlapping selections)."""
    # the float64 root of a float32 square, rounded to float32, is the
    # correctly rounded float32 root on every device; torch's float32 sqrt
    # on the CPU is not (1 ulp off on about 0.7% of bench distances)
    dist = _pair_sq_dists(fa, fb, cell, cell_inv, shifts).double().sqrt_()
    idx = dist.float().mul_(n_bins / r_max).floor_().to(torch.int64)
    del dist
    ok = keep & (idx >= 0) & (idx < n_bins)
    idx.masked_fill_(~ok, n_bins)                     # overflow bucket
    return torch.bincount(idx.reshape(-1), minlength=n_bins + 1)[:n_bins]


def _chunk_frames(n_frames, na, nb):
    """Frames a chunk holds within :data:`_CHUNK_BYTES` of temporaries."""
    pairs = max(1, int(na) * int(nb))
    return max(1, min(int(n_frames), _CHUNK_BYTES // (_PAIR_BYTES * pairs)))


def _pair_hist(frames_a, frames_b, exclude, cell, r_max, n_bins, exact,
               device="cuda"):
    """Histogram of the minimum-image distances of every ``(a, b)`` pair of
    paired frames over ``[0, r_max)`` in ``n_bins`` bins → int64
    ``(n_bins,)`` on the host.  ``frames_a`` ``(F, Na, 3)`` and
    ``frames_b`` ``(F, Nb, 3)`` are NumPy arrays or tensors, taken as
    float32 on ``device``; ``exclude`` ``(Na, Nb)`` marks pairs not to
    count.  The frame axis is cut into chunks of at most
    :data:`_CHUNK_BYTES` of temporaries; the counts do not depend on the
    cut."""
    device = torch.device(device)

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=device)

    F, na = frames_a.shape[:2]
    nb = frames_b.shape[1]
    cell32 = np.asarray(cell, np.float32)
    # the inverse in float32 on the host: the same values for every device
    cell_inv = torch.linalg.inv(torch.from_numpy(cell32)).tolist()
    shifts = _image_shifts(cell32) if exact else None
    keep = ~torch.as_tensor(np.asarray(exclude, bool), device=device)
    chunk = _chunk_frames(F, na, nb)
    total = torch.zeros(int(n_bins), dtype=torch.int64, device=device)
    for s in range(0, F, chunk):
        total += _pair_hist_chunk(on(frames_a[s:s + chunk]),
                                  on(frames_b[s:s + chunk]), keep,
                                  cell32.tolist(), cell_inv, float(r_max),
                                  int(n_bins), shifts)
    return total.cpu().numpy()


def _shell_volumes(r_max, n_bins):
    edges = np.linspace(0.0, r_max, n_bins + 1)
    return 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3), edges


def _resolve_r_max(r_max, cell, exact):
    """Default and validate ``r_max`` against the minimum-image validity
    radius (half the shortest cell height; the full height with the
    27-image exact mode)."""
    height = float(_min_cell_height(cell))
    limit = height if exact else 0.5 * height
    if r_max is None:
        return 0.5 * height
    r_max = float(r_max)
    if r_max > limit * (1 + 1e-9):
        raise ValueError(
            f"r_max={r_max:g} exceeds the minimum-image validity radius "
            f"{limit:g} for this cell (shortest height {height:g}); "
            + ("shrink r_max"
               if exact else "shrink r_max or pass exact=True"))
    return r_max


def _exclude_matrix(mask_a, mask_b):
    """(Na, Nb) bool matrix marking pairs that are the SAME original
    atom under the two selections (handles identical, subset,
    overlapping and disjoint selections alike)."""
    ia = np.where(mask_a)[0]
    ib = np.where(mask_b)[0]
    return ia[:, None] == ib[None, :]


def rdf(traj, cell, mask_a, mask_b=None, r_max=None, n_bins=200,
        exact=False, device="cuda"):
    """Frame-averaged radial distribution function g(r).

    traj ``(F, N, 3)`` wrapped or not (minimum-image throughout);
    ``mask_a``/``mask_b`` boolean atom selections (b defaults to a; any
    atom present in both selections is never paired with itself, and
    the normalization accounts for the overlap).  Returns
    ``(r_centers, g)`` as float64 NumPy arrays.  ``r_max`` defaults to
    half the shortest cell height and is validated against the
    minimum-image limit (``exact=True`` enables the 27-image exact
    distance, extending validity to the full height).  The pair
    histogram runs on ``device``.
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask_a = np.asarray(mask_a, dtype=bool)
    mask_b = mask_a if mask_b is None else np.asarray(mask_b, dtype=bool)
    r_max = _resolve_r_max(r_max, cell, exact)
    exclude = _exclude_matrix(mask_a, mask_b)
    counts = _pair_hist(traj[:, mask_a, :], traj[:, mask_b, :], exclude,
                        cell, r_max, int(n_bins), exact,
                        device=device).astype(np.float64)
    shells, edges = _shell_volumes(float(r_max), int(n_bins))
    vol = float(abs(np.linalg.det(cell)))
    n_pairs = int(mask_a.sum()) * int(mask_b.sum()) - int(exclude.sum())
    norm = traj.shape[0] * n_pairs * shells / vol
    g = np.divide(counts, norm, out=np.zeros_like(counts),
                  where=norm > 0)
    return 0.5 * (edges[1:] + edges[:-1]), g


def van_hove_distinct(traj, cell, mask, lags, r_max=None, n_bins=200,
                      origin_stride=1, exact=False, device="cuda"):
    """Distinct van Hove function G_d(r, t) for the selected ions.

    For each lag t in ``lags`` (frames), histogram the minimum-image
    distances between ion i at an origin frame and every *other* ion j
    at origin+t, averaged over origins, normalized like g(r) (ideal gas
    → 1).  All lags share one origin grid —
    ``range(0, F - max(lags), origin_stride)`` — so every lag has the
    same statistics base.  The ions are copied to ``device`` once.
    Returns ``(r_centers, G)`` with ``G.shape == (len(lags), n_bins)``.
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    r_max = _resolve_r_max(r_max, cell, exact)
    F = traj.shape[0]
    lags = [int(l) for l in lags]
    for lag in lags:
        if not 0 <= lag < F:
            raise ValueError(f"lag {lag} outside 0..{F - 1}")
    n = int(mask.sum())
    # non-empty by construction: lag < F ⇒ the range contains origin 0
    origins = np.arange(0, F - max(lags), int(origin_stride))
    device = torch.device(device)
    ions = torch.as_tensor(np.asarray(traj[:, mask, :], np.float32),
                           device=device)
    at = torch.as_tensor(origins, device=device)
    shells, edges = _shell_volumes(float(r_max), int(n_bins))
    vol = float(abs(np.linalg.det(cell)))
    eye = np.eye(n, dtype=bool)
    out = np.empty((len(lags), n_bins), dtype=np.float64)
    for k, lag in enumerate(lags):
        counts = _pair_hist(ions[at], ions[at + lag], eye, cell, r_max,
                            int(n_bins), exact,
                            device=device).astype(np.float64)
        norm = len(origins) * n * (n - 1) * shells / vol
        out[k] = np.divide(counts, norm, out=np.zeros_like(counts),
                           where=norm > 0)
    return 0.5 * (edges[1:] + edges[:-1]), out


def van_hove_self(traj, cell, mask, lags, r_max=None, n_bins=200,
                  origin_stride=1, exact=False):
    """Self part as the displacement-magnitude density P(r, t) = 4πr²G_s:
    for each lag, the probability density (per unit r, integrates to 1 up
    to ``r_max``) of an ion having moved distance r.  Host float64 over
    the unwrapped trajectory; ``r_max`` here is a histogram window, not
    a minimum-image limit (displacements are unwrapped), and defaults to
    half the shortest cell height for comparability with the distinct
    part.  Returns ``(r_centers, P)`` with
    ``P.shape == (len(lags), n_bins)``.
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    un = unwrap_trajectory(traj[:, mask, :], cell, exact=exact)
    F = un.shape[0]
    if r_max is None:
        r_max = 0.5 * float(_min_cell_height(cell))
    edges = np.linspace(0.0, float(r_max), int(n_bins) + 1)
    dr = edges[1] - edges[0]
    out = np.empty((len(lags), int(n_bins)), dtype=np.float64)
    for k, lag in enumerate(lags):
        lag = int(lag)
        if not 0 <= lag < F:
            raise ValueError(f"lag {lag} outside 0..{F - 1}")
        origins = np.arange(0, F - lag, int(origin_stride))
        disp = un[origins + lag] - un[origins]
        r = np.sqrt((disp ** 2).sum(-1)).ravel()
        counts, _ = np.histogram(r, bins=edges)
        out[k] = counts / (len(r) * dr)
    return 0.5 * (edges[1:] + edges[:-1]), out


def _min_cell_height(cell):
    """Shortest perpendicular height of the (possibly triclinic) cell —
    the minimum-image validity radius is half of it."""
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    # column i of inv is the reciprocal vector of face i; the height is
    # 1/|that column|
    return (1.0 / np.linalg.norm(inv, axis=0)).min()
