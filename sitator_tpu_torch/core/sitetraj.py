"""``SiteTrajectory`` — per-frame site assignments (copy of
``sitator_tpu.core.sitetraj``, so the port imports nothing of the JAX
package; :meth:`SiteTrajectory.assign_to_last_known_site` is NumPy here).

Mirrors the reference ``sitator/SiteTrajectory.py`` (SURVEY.md §3.1): an
``(n_frames, n_mobile) int`` assignment array with sentinel
``SITE_UNKNOWN = -1``, optional per-assignment confidences, a back-reference
to its :class:`SiteNetwork`, and optionally the real cartesian trajectory.

The assignment array is plain int32, produced by the landmark engines and
consumed by :mod:`sitator_tpu_torch.dynamics`.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitenet import SiteNetwork

logger = logging.getLogger(__name__)


def forward_fill_labels(labels, leading="unknown"):
    """Forward-fill ``SITE_UNKNOWN`` (-1) labels along the frame axis —
    the one shared implementation of the 'persist' policy used by the
    jump, diffusion, residence, and vacancy engines.

    ``leading`` controls frames before an ion's first assignment:
    ``'unknown'`` keeps them at -1; ``'first'`` back-fills them with the
    ion's first known site (raising if an ion is never assigned
    anywhere).  Returns an int64 copy of shape ``(F, M)``.
    """
    labels = np.asarray(labels, dtype=np.int64).copy()
    F, M = labels.shape
    known = labels >= 0
    idx = np.where(known, np.arange(F)[:, None], -1)
    ff = np.maximum.accumulate(idx, axis=0)
    out = np.where(ff >= 0,
                   np.take_along_axis(labels, np.maximum(ff, 0), axis=0),
                   -1)
    if leading == "first":
        if (labels < 0).all(axis=0).any():
            raise ValueError("an ion has no assigned site in any frame")
        first = labels[known.argmax(axis=0), np.arange(M)]
        out = np.where(out >= 0, out, first[None, :])
    elif leading != "unknown":
        raise ValueError("leading must be 'unknown' or 'first'")
    return out


class SiteTrajectory:
    SITE_UNKNOWN = -1

    def __init__(self, site_network: SiteNetwork, particle_assignments,
                 confidences=None):
        traj = np.asarray(particle_assignments)
        if traj.ndim != 2:
            raise ValueError("particle_assignments must be (n_frames, n_mobile)")
        self._traj = traj.astype(np.int32, copy=False)
        if confidences is not None:
            confidences = np.asarray(confidences, dtype=np.float32)
            if confidences.shape != self._traj.shape:
                raise ValueError("confidences must match assignments shape")
        self._confs = confidences
        self._sn = site_network
        self._real_traj = None
        if site_network is not None and traj.shape[1] != site_network.n_mobile:
            raise ValueError(
                f"assignments n_mobile={traj.shape[1]} != "
                f"site_network.n_mobile={site_network.n_mobile}")

    # -- basic protocol ----------------------------------------------------
    @property
    def traj(self):
        """(n_frames, n_mobile) int32 site assignments."""
        return self._traj

    @property
    def confidences(self):
        return self._confs

    @property
    def site_network(self) -> SiteNetwork:
        return self._sn

    @site_network.setter
    def site_network(self, sn: SiteNetwork):
        # Reference parity: rebinding to a (remapped) network is allowed.
        if sn.n_mobile != self._traj.shape[1]:
            raise ValueError("new site_network has different n_mobile")
        self._sn = sn

    @property
    def n_frames(self) -> int:
        return self._traj.shape[0]

    @property
    def n_mobile(self) -> int:
        return self._traj.shape[1]

    def __len__(self):
        return self.n_frames

    def __getitem__(self, key):
        """Frame slicing: ``st[a:b]`` → new SiteTrajectory (reference parity)."""
        if isinstance(key, (int, np.integer)):
            return self._traj[key]
        st = SiteTrajectory(self._sn, self._traj[key],
                            None if self._confs is None else self._confs[key])
        if self._real_traj is not None:
            st._real_traj = self._real_traj[key]
        return st

    # -- real trajectory ---------------------------------------------------
    def set_real_traj(self, real_traj):
        """Attach the real cartesian trajectory (n_frames, n_atoms, 3)."""
        real_traj = np.asarray(real_traj)
        if real_traj.shape[0] != self.n_frames or real_traj.ndim != 3:
            raise ValueError("real_traj must be (n_frames, n_atoms, 3)")
        self._real_traj = real_traj

    @property
    def real_trajectory(self):
        return self._real_traj

    def remove_real_traj(self):
        self._real_traj = None

    def real_positions_for_site(self, site: int, return_confidences=False):
        """All real-space positions of mobile ions while assigned to ``site``.

        Used by descriptor sampling (SOAP) and ``NAvgsPerSite`` — reference
        ``SiteTrajectory.real_positions_for_site`` parity.
        """
        if self._real_traj is None:
            raise ValueError("no real trajectory attached (set_real_traj)")
        frames, ions = np.nonzero(self._traj == site)
        mobile_idx = np.flatnonzero(self._sn.mobile_mask)
        pts = self._real_traj[frames, mobile_idx[ions]]
        if return_confidences:
            confs = (np.ones(len(pts), dtype=np.float32) if self._confs is None
                     else self._confs[frames, ions])
            return pts, confs
        return pts

    # -- derived statistics ------------------------------------------------
    @property
    def percent_unassigned(self) -> float:
        return float(np.mean(self._traj == self.SITE_UNKNOWN))

    def compute_site_occupancies(self):
        """Mean occupancy of each site over assigned frames; written onto the
        network as site attribute ``occupancies`` (reference parity)."""
        n_sites = self._sn.n_sites
        counts = np.bincount(self._traj[self._traj >= 0].ravel(),
                             minlength=n_sites).astype(np.float64)
        occ = counts / self.n_frames
        if "occupancies" in self._sn.site_attributes:
            self._sn.remove_attribute("occupancies")
        self._sn.add_site_attribute("occupancies", occ)
        return occ

    def assign_to_last_known_site(self, frame_threshold=None):
        """Fill ``SITE_UNKNOWN`` gaps with each ion's last known site, in
        place.  ``frame_threshold`` bounds how many consecutive unknown frames
        may be filled (None = unbounded).  Logs the residual unassigned
        fraction (reference parity).

        Two running maxima over the frame axis: the index of the last
        known frame, and from it the site (the reference runs the same
        forward fill as prefix scans in JAX)."""
        before = self.percent_unassigned
        traj = self._traj
        F = traj.shape[0]
        fidx = np.arange(F, dtype=np.int64)[:, None]
        last_seen = np.maximum.accumulate(np.where(traj >= 0, fidx, -1),
                                          axis=0)
        filled = np.where(last_seen >= 0, np.take_along_axis(
            traj, np.maximum(last_seen, 0), axis=0), traj)
        if frame_threshold is not None:
            filled = np.where(fidx - last_seen <= int(frame_threshold),
                              filled, traj)
        self._traj = filled.astype(np.int32)
        after = self.percent_unassigned
        logger.info("assign_to_last_known_site: unassigned %.3f%% -> %.3f%%",
                    100 * before, 100 * after)
        return after

    def jumps(self):
        """Iterate ``(frame, ion, from_site, to_site)`` for every site change.

        Unknown-site frames do not themselves emit jumps; an ion's previous
        site persists across unknown gaps (matching JumpAnalysis defaults).
        """
        last = np.full(self.n_mobile, self.SITE_UNKNOWN, dtype=np.int32)
        for f in range(self.n_frames):
            row = self._traj[f]
            known = row != self.SITE_UNKNOWN
            changed = known & (last != self.SITE_UNKNOWN) & (row != last)
            for ion in np.flatnonzero(changed):
                yield f, int(ion), int(last[ion]), int(row[ion])
            last = np.where(known, row, last)

    # -- plotting (not ported: ROADMAP item 12.13) ---------------------------
    def _no_plots(self):
        raise NotImplementedError(
            "SiteTrajectory plots need the visualization layer, which is "
            "not ported yet (ROADMAP item 12.13)")

    def plot_frame(self, frame, **kwargs):
        self._no_plots()

    def plot_site(self, site, **kwargs):
        self._no_plots()

    def plot_particle_trajectory(self, particle, **kwargs):
        self._no_plots()

    def __repr__(self):
        return (f"SiteTrajectory(n_frames={self.n_frames},"
                f" n_mobile={self.n_mobile},"
                f" unassigned={100 * self.percent_unassigned:.2f}%)")

    # -- serialization -----------------------------------------------------
    _FORMAT_VERSION = 1

    def save(self, file, with_real_traj=False):
        d = {
            "__sitetraj_version__": np.int64(self._FORMAT_VERSION),
            "traj": self._traj,
        }
        if self._confs is not None:
            d["confidences"] = self._confs
        if with_real_traj and self._real_traj is not None:
            d["real_traj"] = self._real_traj
        # Embed the network under a prefix so one archive round-trips both.
        import io as _io
        buf = _io.BytesIO()
        self._sn.save(buf)
        d["site_network_npz"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        np.savez_compressed(file, **d)

    @classmethod
    def load(cls, file) -> "SiteTrajectory":
        with np.load(file, allow_pickle=False) as data:
            d = dict(data)
        version = int(d.pop("__sitetraj_version__", 1))
        if version > cls._FORMAT_VERSION:
            raise ValueError(f"unsupported SiteTrajectory format v{version}")
        import io as _io
        sn = SiteNetwork.load(_io.BytesIO(d["site_network_npz"].tobytes()))
        st = cls(sn, d["traj"], d.get("confidences"))
        if "real_traj" in d:
            st._real_traj = d["real_traj"]
        return st
