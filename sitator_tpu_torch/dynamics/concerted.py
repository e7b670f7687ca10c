"""Concerted (cooperative, "string-like") multi-ion jump detection.

Beyond-reference capability (upstream ``sitator`` reports only per-edge
jump counts, SURVEY.md §3.4): in superionic conductors a large fraction
of migration events are **cooperative** — several ions hop within a few
frames of each other along site-connected paths (vacancy trains,
interstitialcy knock-on, cyclic exchanges).  Whether transport is
dominated by isolated hops or by such strings is the mechanistic
question behind the correlation factor ``f`` and the Haven ratio this
package already measures (:class:`~sitator_tpu_torch.dynamics.
SiteDiffusionAnalysis`, :class:`~sitator_tpu_torch.dynamics.
DiffusionAnalysis`); this module answers it at event resolution.

Definition used here (exact, label-based):

1. every site change of every mobile ion is a *jump*
   ``(frame, ion, from_site, to_site)`` (identical event extraction to
   :class:`~sitator_tpu_torch.dynamics.JumpAnalysis`, including the
   ``unknown_policy`` semantics);
2. two jumps are *linked* when one ion's destination is the other's
   origin (a site handoff) and they occur within ``window`` frames of
   each other;
3. an *event* is a connected component of jumps under that relation
   (union-find, so chains of handoffs merge transitively into one
   string of any length).

Events are classified by the number of **distinct ions** involved
(consecutive hops of a single fast ion chain into one event but stay
size-1, i.e. non-cooperative) and by topology: a *ring* event is a
cyclic exchange — the multiset of origin sites equals the multiset of
destination sites, so no net vacancy is transported — while a *chain*
event propagates a vacancy from its head to its tail.

Host-side post-processing over the discrete jump list (one pass, tiny
compared to assignment; same design stance as
:mod:`sitator_tpu_torch.ops.msd` — exactness over device residency for
once-per-trajectory reductions).

Diagnostic pairing: running this analysis on a
:class:`~sitator_tpu_torch.dynamics.KineticMonteCarlo` resample of the same
network gives the *chance-coincidence baseline* (KMC walkers are
independent by construction); MD cooperativity above that baseline is
mechanistic signal the single-particle Markov model cannot carry
(``tests/test_concerted.py::test_kmc_resample_gives_chance_baseline``).
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu_torch.core.sitetraj import SiteTrajectory, forward_fill_labels

logger = logging.getLogger(__name__)

__all__ = ["ConcertedJumpAnalysis"]


def _extract_jumps(labels, unknown_policy):
    """Vectorized jump list: (frames, ions, from_sites, to_sites).

    ``persist``: an ion's site survives unassigned frames (forward
    fill), so re-assignment after a gap to a NEW site is one jump from
    the pre-gap site.  ``break``: an unknown frame ends the residence;
    no jump is recorded across the gap.
    """
    labels = np.asarray(labels)
    if labels.shape[0] < 2:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    cur = labels[1:]
    prev = (forward_fill_labels(labels, leading="unknown")[:-1]
            if unknown_policy == "persist" else labels[:-1])
    mask = (cur >= 0) & (prev >= 0) & (cur != prev)
    frames, ions = np.nonzero(mask)
    return (frames.astype(np.int64) + 1, ions.astype(np.int64),
            prev[mask].astype(np.int64), cur[mask].astype(np.int64))


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:                      # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class ConcertedJumpAnalysis:
    """Group jumps into cooperative events via site handoffs.

    Parameters
    ----------
    window : int
        Two jumps sharing a site handoff (one's destination is the
        other's origin) are linked when their frames differ by at most
        ``window``.  ``window=0`` links only same-frame handoffs; the
        default 1 tolerates the one-frame ambiguity of discrete
        assignment.
    min_event_size : int
        Minimum number of DISTINCT ions for an event to count as
        concerted (default 2).
    unknown_policy : ``'persist'`` | ``'break'``
        Same semantics as :class:`~sitator_tpu_torch.dynamics.JumpAnalysis`.

    After ``run(st)`` (returns ``st`` unchanged, results as attributes):

    - ``n_jumps_``, ``n_events_`` — totals;
    - ``event_jumps_`` — list of index arrays into the flat jump list
      (``jump_frames_``, ``jump_ions_``, ``jump_from_``, ``jump_to_``),
      each sorted by frame;
    - ``event_n_ions_``, ``event_n_jumps_``, ``event_span_``,
      ``event_is_ring_`` — per-event arrays (span = last frame − first
      frame of the event);
    - ``event_size_histogram_`` — ``histogram[k]`` = number of events
      involving exactly ``k`` distinct ions (index 0 unused);
    - ``cooperativity_fraction_`` — fraction of all jumps belonging to
      events with ``≥ min_event_size`` distinct ions;
    - ``n_ring_events_``, ``n_chain_events_`` — ring/chain split among
      concerted events.

    Site attribute written onto the network: ``concerted_fraction`` —
    per site, the fraction of departures from that site that belong to
    a concerted event (``nan`` where a site has no departures).
    """

    def __init__(self, window=1, min_event_size=2,
                 unknown_policy="persist", verbose=True):
        if window < 0:
            raise ValueError("window must be >= 0")
        if min_event_size < 2:
            raise ValueError("min_event_size must be >= 2 (size-1 "
                             "events are by definition not concerted)")
        if unknown_policy not in ("persist", "break"):
            raise ValueError("unknown_policy must be 'persist' or "
                             "'break'")
        self.window = int(window)
        self.min_event_size = int(min_event_size)
        self.unknown_policy = unknown_policy
        self.verbose = verbose

    def run(self, st: SiteTrajectory) -> SiteTrajectory:
        sn = st.site_network
        frames, ions, src, dst = _extract_jumps(st.traj,
                                                self.unknown_policy)
        J = len(frames)
        self.jump_frames_, self.jump_ions_ = frames, ions
        self.jump_from_, self.jump_to_ = src, dst

        uf = _UnionFind(J)
        if J:
            # per shared site: two-pointer over frame-sorted departures
            # and arrivals; union every pair within the window
            order_dep = np.lexsort((frames, src))
            order_arr = np.lexsort((frames, dst))
            dep_sites = src[order_dep]
            arr_sites = dst[order_arr]
            dep_starts = {int(s): i for i, s in enumerate(dep_sites)
                          if i == 0 or dep_sites[i - 1] != s}
            a0 = 0
            for s, a_lo in [(int(s), i) for i, s in enumerate(arr_sites)
                            if i == 0 or arr_sites[i - 1] != s]:
                if s not in dep_starts:
                    continue
                a_hi = a_lo
                while a_hi < J and arr_sites[a_hi] == s:
                    a_hi += 1
                d = dep_starts[s]
                a0 = a_lo
                while d < J and dep_sites[d] == s:
                    jd = order_dep[d]
                    fd = frames[jd]
                    while (a0 < a_hi
                           and frames[order_arr[a0]] < fd - self.window):
                        a0 += 1
                    k = a0
                    while (k < a_hi
                           and frames[order_arr[k]] <= fd + self.window):
                        uf.union(jd, order_arr[k])
                        k += 1
                    d += 1

        roots = np.array([uf.find(j) for j in range(J)], dtype=np.int64)
        events = []
        if J:
            order = np.argsort(roots, kind="stable")
            sorted_roots = roots[order]
            cut = np.flatnonzero(np.diff(sorted_roots)) + 1
            for grp in np.split(order, cut):
                events.append(grp[np.argsort(frames[grp], kind="stable")])

        n_ions = np.array([len(np.unique(ions[e])) for e in events],
                          dtype=np.int64)
        n_jumps = np.array([len(e) for e in events], dtype=np.int64)
        span = np.array([int(frames[e[-1]] - frames[e[0]])
                         for e in events], dtype=np.int64)
        # ring: cyclic exchange — origins and destinations coincide as
        # multisets, so the event transports no net vacancy
        is_ring = np.array(
            [np.array_equal(np.sort(src[e]), np.sort(dst[e]))
             for e in events], dtype=bool)

        concerted = n_ions >= self.min_event_size
        self.event_jumps_ = events
        self.event_n_ions_ = n_ions
        self.event_n_jumps_ = n_jumps
        self.event_span_ = span
        self.event_is_ring_ = is_ring
        self.n_jumps_ = J
        self.n_events_ = len(events)
        self.event_size_histogram_ = (
            np.bincount(n_ions) if len(events)
            else np.zeros(1, dtype=np.int64))
        coop_jumps = int(n_jumps[concerted].sum()) if len(events) else 0
        self.cooperativity_fraction_ = (coop_jumps / J) if J else 0.0
        self.n_ring_events_ = int((concerted & is_ring).sum())
        self.n_chain_events_ = int((concerted & ~is_ring).sum())

        # site attribute: fraction of departures that are cooperative
        S = sn.n_sites
        dep_total = np.bincount(src, minlength=S).astype(np.float64)
        coop_mask = np.zeros(J, dtype=bool)
        for e, c in zip(events, concerted):
            if c:
                coop_mask[e] = True
        dep_coop = np.bincount(src[coop_mask], minlength=S)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(dep_total > 0,
                            dep_coop / np.maximum(dep_total, 1), np.nan)
        if "concerted_fraction" in sn.site_attributes:
            sn.remove_attribute("concerted_fraction")
        sn.add_site_attribute("concerted_fraction", frac)

        if self.verbose:
            logger.info(
                "ConcertedJumpAnalysis: %d jumps -> %d events "
                "(%.1f%% of jumps cooperative; %d rings, %d chains)",
                J, len(events), 100 * self.cooperativity_fraction_,
                self.n_ring_events_, self.n_chain_events_)
        return st

    def plot_event_sizes(self, fig=None, ax=None):
        """Bar chart of the event-size histogram (distinct ions per
        event), rings and chains stacked for sizes ≥ min_event_size."""
        import matplotlib.pyplot as plt
        if not hasattr(self, "event_n_ions_"):
            raise ValueError("ConcertedJumpAnalysis has not been run")
        if ax is None:
            fig, ax = plt.subplots()
        elif fig is None:
            fig = ax.figure
        n = self.event_n_ions_
        if len(n) == 0:
            ax.set_title("no jump events")
            return fig
        kmax = int(n.max())
        ks = np.arange(1, kmax + 1)
        rings = np.array([int(((n == k) & self.event_is_ring_).sum())
                          for k in ks])
        total = np.array([int((n == k).sum()) for k in ks])
        ax.bar(ks, total - rings, label="chain")
        ax.bar(ks, rings, bottom=total - rings, label="ring")
        ax.set_xlabel("distinct ions per event")
        ax.set_ylabel("events")
        ax.legend()
        return fig
