"""Trajectory unwrapping (host, float64; the start of the counterpart of
``sitator_tpu.ops.msd`` — the mean-squared-displacement estimators are
still to port).

:func:`unwrap_trajectory`: wrapped → continuous coordinates by chaining
minimum-image frame-to-frame displacements (triclinic-safe, one ``cumsum``
over the frame axis — no Python loop).  Deliberately host-side NumPy
float64, like the host ``PBCCalculator``: the displacement sums that build
on it cancel catastrophically in float32 on long drifting trajectories.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu_torch.ops.pbc import PBCCalculator

__all__ = ["unwrap_trajectory"]


def unwrap_trajectory(traj, cell, exact: bool = False):
    """Continuous coordinates from a wrapped ``(F, N, 3)`` trajectory.

    Frame-to-frame displacements are taken minimum-image (the physical
    assumption: no atom moves more than half a cell vector per frame —
    standard for MD output) and chained by a cumulative sum; frame 0 is
    kept as-is, so the result starts at the input's first frame.
    """
    traj = np.asarray(traj, dtype=np.float64)
    F, N = traj.shape[:2]
    calc = PBCCalculator(cell, exact=exact)
    raw = (traj[1:] - traj[:-1]).reshape(-1, 3)
    disp = np.asarray(calc._min_image_disp(raw)).reshape(F - 1, N, 3)
    out = np.empty_like(traj)
    out[0] = traj[0]
    np.cumsum(disp, axis=0, out=out[1:])
    out[1:] += traj[0]
    return out
