"""``JumpAnalysis`` — hop detection and jump statistics (counterpart of
``sitator_tpu.dynamics.jump_analysis``).

Scans the :class:`SiteTrajectory` tracking each ion's last known site and
records a hop at every site change.  Writes onto the ``SiteNetwork``:

- edge attrs ``n_ij`` (hop counts), ``p_ij`` (row-normalised jump
  probabilities), ``jump_lag`` (mean residence before an i→j jump; ``nan``
  where no such jump occurred);
- site attrs ``occupancies``, ``residence_times`` (mean frames between
  jumps), ``total_corrected_residences`` (total frames occupied).

The tallies run on ``device`` in int64 (:func:`jump_stats_exact`).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core import SiteTrajectory
from sitator_tpu_torch.ops.jumps import jump_stats_exact

logger = logging.getLogger(__name__)


class JumpAnalysis:
    """``unknown_policy``: 'persist' (an ion's site survives unassigned
    frames) or 'break' (an unknown frame ends the residence).
    ``device``: torch device the tallies run on (default 'cuda')."""

    def __init__(self, unknown_policy="persist", verbose=True, device="cuda"):
        self.unknown_policy = unknown_policy
        self.verbose = verbose
        self.device = device
        self._stats = None

    def run(self, st: SiteTrajectory) -> SiteTrajectory:
        sn = st.site_network
        S = sn.n_sites
        stats = jump_stats_exact(st.traj, S,
                                 unknown_policy=self.unknown_policy,
                                 device=self.device)
        self._stats = {k: np.asarray(v) for k, v in stats.items()}

        n_ij = self._stats["n_ij"].astype(np.float64)
        row = n_ij.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            p_ij = np.where(row > 0, n_ij / np.maximum(row, 1), 0.0)
            jump_lag = np.where(self._stats["n_ij"] > 0,
                                self._stats["lag_sum"] / np.maximum(
                                    self._stats["n_ij"], 1), np.nan)
            res_times = np.where(self._stats["res_cnt"] > 0,
                                 self._stats["res_sum"] / np.maximum(
                                     self._stats["res_cnt"], 1), np.nan)
        occ = self._stats["occ_counts"].astype(np.float64) / st.n_frames

        for name in ("n_ij", "p_ij", "jump_lag"):
            if name in sn.edge_attributes:
                sn.remove_attribute(name)
        for name in ("occupancies", "residence_times",
                     "total_corrected_residences"):
            if name in sn.site_attributes:
                sn.remove_attribute(name)
        sn.add_edge_attribute("n_ij", self._stats["n_ij"].astype(np.int64))
        sn.add_edge_attribute("p_ij", p_ij)
        sn.add_edge_attribute("jump_lag", jump_lag)
        sn.add_site_attribute("occupancies", occ)
        sn.add_site_attribute("residence_times", res_times)
        sn.add_site_attribute(
            "total_corrected_residences",
            self._stats["occ_counts"].astype(np.int64))

        if self.verbose:
            logger.info("JumpAnalysis: %d jumps over %d frames (%d sites)",
                        int(n_ij.sum()), st.n_frames, S)
        return st

    @property
    def n_jumps(self) -> int:
        if self._stats is None:
            raise ValueError("JumpAnalysis has not been run")
        return int(self._stats["n_ij"].sum())

    def plot_jump_lag(self, sn=None, fig=None, ax=None, cmap="viridis"):
        """Heatmap of the jump-lag matrix (mean residence before an i→j
        jump)."""
        import matplotlib.pyplot as plt
        if self._stats is None:
            raise ValueError("JumpAnalysis has not been run")
        if ax is None:
            fig, ax = plt.subplots()
        elif fig is None:
            fig = ax.figure
        with np.errstate(invalid="ignore"):
            lag = np.where(self._stats["n_ij"] > 0,
                           self._stats["lag_sum"] /
                           np.maximum(self._stats["n_ij"], 1), np.nan)
        im = ax.imshow(lag, cmap=cmap)
        fig.colorbar(im, ax=ax, label="mean residence before jump (frames)")
        ax.set_xlabel("to site")
        ax.set_ylabel("from site")
        return fig

    def jump_lag_by_type(self, sn):
        """Mean jump lag aggregated over (from_type, to_type) pairs."""
        if sn.site_types is None:
            raise ValueError("SiteNetwork has no site_types")
        types = np.unique(sn.site_types)
        out = np.full((len(types), len(types)), np.nan)
        lag = self._stats["lag_sum"]
        cnt = self._stats["n_ij"]
        for a, ta in enumerate(types):
            ia = sn.site_types == ta
            for b, tb in enumerate(types):
                ib = sn.site_types == tb
                c = cnt[np.ix_(ia, ib)].sum()
                if c > 0:
                    out[a, b] = lag[np.ix_(ia, ib)].sum() / c
        return types, out
