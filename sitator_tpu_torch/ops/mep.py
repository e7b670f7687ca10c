"""Minimum-energy-path refinement on periodic density grids — the
simplified string method (E, Ren & Vanden-Eijnden, J. Chem. Phys. 126,
164103 (2007)) on the free-energy landscape ``F(r) = -kB T ln rho(r)``
(counterpart of ``sitator_tpu.ops.mep``).

The landscape is the (log-)density grid interpolated trilinearly with
periodic wrap; its gradient is the analytic gradient of the interpolation
weights (piecewise multilinear, so exact — no finite differences); one
string iteration is a clipped gradient-descent step on every interior node
plus an equal-arc-length reparametrization.  All edges relax at once as
batched ``(E, P, 3)`` tensors on ``device``; the iterations are a Python
loop of small tensor operations.

Working in log-density (not density) keeps gradients bounded where
sampling is thin: ``rho`` is floored at ``rho_floor_rel * max(rho)``
before the log, so unsampled voids present a steep-but-finite uphill
wall that pushes the string back into sampled territory — a straight
seed crossing a void can be *rescued* by the refinement.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["refine_string_paths"]


def _grad_neg_log_rho(log_rho, inv_cell, pts):
    """Gradient of ``V(r) = -log_rho(r)`` at cartesian ``pts (..., 3)``,
    ``log_rho`` interpolated trilinearly with periodic wrap (bin CENTERS at
    fractional ``(i + 0.5) / n``).  Within a cell of the interpolation the
    value is multilinear in the offsets ``t``, so the gradient along axis
    ``a`` is the other two axes' weights times the difference of the corner
    values along ``a``; the chain rule through ``x = frac · n − 0.5`` and
    ``frac = r @ inv_cell`` gives the cartesian gradient."""
    n_bins = torch.tensor(log_rho.shape, device=pts.device)
    frac = pts @ inv_cell
    frac = frac - torch.floor(frac)
    x = frac * n_bins - 0.5
    i0 = torch.floor(x)
    t = x - i0
    i0 = i0.long()
    lo = i0 % n_bins                                   # (..., 3)
    hi = (i0 + 1) % n_bins
    w = (1.0 - t, t)
    ix, iy, iz = ((lo[..., a], hi[..., a]) for a in range(3))
    dx = torch.zeros_like(t)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                v = log_rho[ix[di], iy[dj], iz[dk]]
                sign = (1.0 if di else -1.0, 1.0 if dj else -1.0,
                        1.0 if dk else -1.0)
                dx[..., 0] += sign[0] * w[dj][..., 1] * w[dk][..., 2] * v
                dx[..., 1] += sign[1] * w[di][..., 0] * w[dk][..., 2] * v
                dx[..., 2] += sign[2] * w[di][..., 0] * w[dj][..., 1] * v
    # d(-val)/dr_a = -Σ_b inv_cell[a, b] · n_b · d val/d x_b
    return -(dx * n_bins) @ inv_cell.T


def _interp_rows(x, xp, fp):
    """``numpy.interp`` row by row: ``x (Q,)`` shared abscissae, ``xp
    (E, P)`` increasing sample points per row, ``fp (E, P, C)`` values.
    Returns ``(E, Q, C)``.

    The interval is found with a right-sided search, so at equal abscissae
    the later sample wins; an interval narrower than the smallest float
    spacing returns its left value; ``x`` outside ``[xp[0], xp[-1]]``
    takes the end values."""
    E, P = xp.shape
    xq = x.expand(E, -1).contiguous()
    i = torch.searchsorted(xp.contiguous(), xq, right=True).clamp_(1, P - 1)
    x0 = torch.gather(xp, 1, i - 1)
    dx = torch.gather(xp, 1, i) - x0
    C = fp.shape[-1]
    f0 = torch.gather(fp, 1, (i - 1)[..., None].expand(-1, -1, C))
    df = torch.gather(fp, 1, i[..., None].expand(-1, -1, C)) - f0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    slope = (xq - x0) / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0[..., None], f0, f0 + slope[..., None] * df)
    f = torch.where((xq < xp[:, :1])[..., None], fp[:, :1], f)
    return torch.where((xq > xp[:, -1:])[..., None], fp[:, -1:], f)


def _reparam(pts, s_target):
    """Redistribute every path's nodes to equal arc length."""
    seg = torch.linalg.norm(pts[:, 1:] - pts[:, :-1], dim=-1) + 1e-12
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)],
                    dim=1)
    cum = cum / cum[:, -1:]
    return _interp_rows(s_target, cum, pts)


def _refine(log_rho, inv_cell, paths, iterations, max_step, smoothing):
    """``iterations`` simplified-string iterations over all paths.

    paths : (E, P, 3) cartesian node positions (endpoints fixed).
    Returns the relaxed (E, P, 3) paths.
    """
    P = paths.shape[1]
    s_target = torch.linspace(0.0, 1.0, P, dtype=paths.dtype,
                              device=paths.device)
    interior = torch.ones(P, 1, dtype=paths.dtype, device=paths.device)
    interior[0] = interior[-1] = 0.0                 # endpoints pinned
    pts = paths
    for _ in range(iterations):
        disp = -max_step * _grad_neg_log_rho(log_rho, inv_cell, pts)
        norm = torch.linalg.norm(disp, dim=-1, keepdim=True)
        disp = disp * torch.clamp_max(max_step / (norm + 1e-30), 1.0)
        pts = pts + disp * interior
        # mild along-string diffusion: damps node-to-node wiggle that
        # sampling-noise gradients inject in flat regions (arc-length
        # inflation), at negligible cost in genuine curvature
        lap = 0.5 * (pts[:, :-2] + pts[:, 2:]) - pts[:, 1:-1]
        pts = torch.cat([pts[:, :1], pts[:, 1:-1] + smoothing * lap,
                         pts[:, -1:]], dim=1)
        pts = _reparam(pts, s_target)
    return pts


def refine_string_paths(rho, cell, paths, iterations=300, max_step=None,
                        smoothing=0.2, rho_floor_rel=1e-9, device="cuda"):
    """Relax straight seed paths to minimum-energy paths on a periodic
    density grid.

    Parameters
    ----------
    rho : (n, n, n) non-negative density grid in fractional space
        (bin centers at ``(i + 0.5) / n``), e.g. from
        :func:`sitator_tpu_torch.ops.density.smooth_density`.
    cell : (3, 3) cell matrix (rows are lattice vectors).
    paths : (E, P, 3) cartesian node positions per edge, endpoints at
        the site centers (the straight minimum-image discretization is
        the natural seed).  Nodes may lie outside the cell — the path
        stays continuous in cartesian space and only the interpolation
        wraps.
    iterations : string iterations (a fixed count).
    max_step : per-node displacement cap per iteration, in length
        units; default ``0.15 ×`` the smallest grid spacing.  Total
        travel capacity is ``iterations * max_step`` — the default pair
        allows ~45 grid spacings of lateral relaxation.
    smoothing : along-string Laplacian damping per iteration (0 turns
        it off) — keeps sampled-density noise from inflating the arc
        length in flat regions.
    rho_floor_rel : the density is floored at this fraction of its max
        before the log, bounding gradients where sampling is empty.

    device : where the relaxation runs (default ``"cuda"``), in float32.

    Returns the relaxed ``(E, P, 3)`` float64 paths.  Barriers should
    then be read off the refined nodes with the same interpolation used
    for straight paths (``_trilinear_periodic`` on the *unfloored*
    density), so NaN semantics for genuinely unsampled transition
    regions are unchanged.
    """
    rho = np.asarray(rho, dtype=np.float64)
    if rho.ndim != 3:
        raise ValueError("rho must be a 3-D grid")
    paths = np.asarray(paths, dtype=np.float64)
    if paths.ndim != 3 or paths.shape[-1] != 3:
        raise ValueError("paths must have shape (E, P, 3)")
    if paths.shape[1] < 3:
        return paths.copy()                 # nothing interior to relax
    if rho.max() <= 0:
        raise ValueError("rho has no positive density")
    cell = np.asarray(cell, dtype=np.float64)
    if max_step is None:
        from sitator_tpu_torch.ops.density import _cell_heights
        spacing = _cell_heights(cell) / np.asarray(rho.shape)
        max_step = 0.15 * float(spacing.min())
    log_rho = np.log(np.maximum(rho, rho_floor_rel * rho.max()))
    device = torch.device(device)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = _refine(on(log_rho), on(np.linalg.inv(cell)), on(paths),
                  int(iterations), float(max_step), float(smoothing))
    return out.cpu().numpy().astype(np.float64)
