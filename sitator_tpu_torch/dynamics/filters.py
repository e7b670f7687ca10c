"""Trajectory/network post-filters: unoccupied-site removal and flicker
debouncing.

Reference parity: ``sitator/dynamics/RemoveUnoccupiedSites.py`` and
``RemoveShortJumps`` (SURVEY.md §3.4 ⚠).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitetraj import SiteTrajectory

logger = logging.getLogger(__name__)


class RemoveUnoccupiedSites:
    """Drop sites with occupancy below ``threshold`` (fraction of frames;
    default: any site never visited).  Subsets the network — remapping all
    site/edge attributes — and relabels the trajectory; assignments to
    removed sites become ``SITE_UNKNOWN``."""

    def __init__(self, threshold=0.0, verbose=True):
        self.threshold = float(threshold)
        self.verbose = verbose

    def run(self, st: SiteTrajectory) -> SiteTrajectory:
        sn = st.site_network
        S = sn.n_sites
        t = st.traj
        counts = np.bincount(t[t >= 0].ravel(), minlength=S)
        occ = counts / st.n_frames
        keep = occ > self.threshold if self.threshold > 0 else counts > 0
        kept = np.flatnonzero(keep)
        remap = np.full(S, -1, dtype=np.int32)
        remap[kept] = np.arange(len(kept))
        out = sn.subset(kept)
        traj = t.copy()
        ok = traj >= 0
        traj[ok] = remap[traj[ok]]
        confs = st.confidences
        st2 = SiteTrajectory(out, traj, confs)
        if st.real_trajectory is not None:
            st2.set_real_traj(st.real_trajectory)
        if self.verbose:
            logger.info("RemoveUnoccupiedSites: %d -> %d sites", S, len(kept))
        return st2


class RemoveShortJumps:
    """Debounce flickers: an A→B→A excursion where the stay at B is shorter
    than ``frame_threshold`` frames is reassigned to A (run-length pass per
    ion; repeated until stable so nested flickers collapse)."""

    def __init__(self, frame_threshold=2, max_passes=10, verbose=True):
        self.frame_threshold = int(frame_threshold)
        self.max_passes = int(max_passes)
        self.verbose = verbose

    def run(self, st: SiteTrajectory) -> SiteTrajectory:
        traj = st.traj.copy()
        n_fixed_total = 0
        for _ in range(self.max_passes):
            n_fixed = 0
            for ion in range(traj.shape[1]):
                n_fixed += self._debounce_column(traj[:, ion])
            n_fixed_total += n_fixed
            if n_fixed == 0:
                break
        if self.verbose:
            logger.info("RemoveShortJumps: reassigned %d flicker runs",
                        n_fixed_total)
        st2 = SiteTrajectory(st.site_network, traj, st.confidences)
        if st.real_trajectory is not None:
            st2.set_real_traj(st.real_trajectory)
        return st2

    def _debounce_column(self, col):
        """In-place debounce of one ion's site sequence; returns #fixed."""
        # run-length encode, ignoring unknown (-1) frames which neither
        # break nor extend a run
        known_idx = np.flatnonzero(col >= 0)
        if len(known_idx) < 3:
            return 0
        vals = col[known_idx]
        change = np.flatnonzero(np.diff(vals) != 0) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(vals)]])
        run_vals = vals[starts]
        run_lens = ends - starts
        fixed = 0
        for r in range(1, len(run_vals) - 1):
            if (run_lens[r] < self.frame_threshold
                    and run_vals[r - 1] == run_vals[r + 1]
                    and run_vals[r] != run_vals[r - 1]):
                sel = known_idx[starts[r]:ends[r]]
                col[sel] = run_vals[r - 1]
                run_vals[r] = run_vals[r - 1]
                fixed += 1
        return fixed
