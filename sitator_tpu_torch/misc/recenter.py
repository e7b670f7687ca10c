"""``RecenterTrajectory`` — remove host-lattice center-of-mass drift.

Reference parity: ``RecenterTrajectory`` (SURVEY.md §3.7 ⚠): subtract the
per-frame displacement of the static sublattice's center of mass so the
landmark basis stays registered to the host lattice.  Operates in place or
returns a copy.

Displacements are chained
frame-to-frame minimum image (``unwrap_trajectory``), so the correction
stays exact for arbitrarily large TOTAL drift — a frame-0 minimum image
would silently wrap once the accumulated drift exceeds half a cell
vector.
"""
from __future__ import annotations

import numpy as np


class RecenterTrajectory:
    def __init__(self, masses=None, verbose=True):
        self.masses = masses
        self.verbose = verbose

    def run(self, static_mask, traj, cell=None, in_place=False):
        """traj (n_frames, n_atoms, 3); static_mask (n_atoms,).  With
        ``cell`` (3, 3) given, the static sublattice is unwrapped by
        chained minimum-image frame differences before the COM is taken,
        so wrapped trajectories AND unbounded accumulated drift are both
        handled (each atom may not move more than half a cell vector
        per frame — the standard MD assumption).  Pass ``cell=None``
        only for unwrapped coordinates."""
        traj = np.asarray(traj)
        out = traj if in_place else traj.copy()
        static = traj[:, static_mask, :]
        if cell is not None:
            from sitator_tpu_torch.ops.msd import unwrap_trajectory
            static = unwrap_trajectory(static, cell)
        disp = static - static[0:1]
        if self.masses is not None:
            w = np.asarray(self.masses, dtype=np.float64)
            w = w / w.sum()
            com = np.einsum("fnc,n->fc", disp, w)
        else:
            com = disp.mean(axis=1)
        out -= com[:, None, :]
        return out
