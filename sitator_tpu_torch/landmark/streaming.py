"""``StreamingLandmarkAnalysis`` — the out-of-core pipeline (counterpart of
``sitator_tpu.landmark.streaming``).

A 10^6-frame x 10^4-atom trajectory is ~120 GB of float32 positions, far
beyond device memory.  This engine streams it:

- **pass 1** (:meth:`StreamingLandmarkAnalysis.fit_centers`): landmark
  vectors on an evenly strided frame subsample (the unique-atom kernel K2
  when the basis shares vertices, else the dense contraction) → dot-product
  clustering on the device → fixed cluster centres;
- **pass 2** (:meth:`StreamingLandmarkAnalysis.run`): :class:`ChunkedFeeder`
  reads frame blocks on a host thread while the device assigns each block
  (K1 when the basis shares vertices, else the gather kernel K3, or the
  dense route) and folds it into per-site accumulators that live on the
  device: occupancy counts, confidence sums, toroidal (circular-mean) centre
  sums, the multiple-occupancy counter, and the jump scan whose
  ``(last site, residence)`` carry chains exactly across blocks.  Labels can
  spill to a memmapped ``.npy``.

Result: an annotated :class:`SiteNetwork` (centres, occupancies, n_ij, p_ij,
jump_lag, residence_times) without the trajectory or the label matrix ever
being resident in host memory at once.

Differences from the reference, none of which changes a result:

- the integer tallies are int64 and the float sums float64 on the device, so
  the reference's epoch spill into exact host totals and its exact-mode
  routing of hazardous epochs through a host int64 jump scan are not needed;
- the run-ahead dispatcher (``pipeline_depth > 0``, the default) snapshots
  the accumulators by copying them (tensors are folded in place here), and
  moves frames, labels and drift over two copy streams and pinned buffers
  (:class:`_Lanes`); on a CPU device the same window runs without them;
- a block shorter than ``block_frames`` (the last one, or a short input) is
  computed on its own frames, padded only up to a multiple of the mesh size,
  where the reference pads every block to ``block_frames`` for its one
  compiled shape; ``packed_retire`` (drift riding in the egress columns) is
  not ported;
- a mesh that spans processes is refused when the engine is built, where
  the reference's engine takes a pod's mesh and fails when it fetches its
  labels; across processes the analysis steps of
  :mod:`sitator_tpu_torch.parallel.pipeline` run on every rank.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from sitator_tpu_torch.core import SiteNetwork
from sitator_tpu_torch.io import ArrayTrajectory, ChunkedFeeder
from sitator_tpu_torch.ops import _cuda
from sitator_tpu_torch.ops import landmark as lmops
from sitator_tpu_torch.ops.cluster import dotprod_fit
from sitator_tpu_torch.ops.jumps import jump_fold
from sitator_tpu_torch.parallel.mesh import (ShardedFrames, bind_mesh,
                                             gather_frames, pad_frames,
                                             place_frames, run_sharded,
                                             shard_frames, take_columns)
from sitator_tpu_torch.io._shared import N_THREADS, pool_counters
from sitator_tpu_torch.util.errors import (MultipleOccupancyError,
                                           StaticLatticeError)
from sitator_tpu_torch.util.progress import get_progress_bar
from sitator_tpu_torch.util.timing import (NO_BLOCK, Span, SpanLog,
                                           clock_offset_ns,
                                           profiler_recording, record_run,
                                           stage_marks)

logger = logging.getLogger(__name__)

__all__ = ["StreamingLandmarkAnalysis", "pack12_width"]

# The mean width, in columns, of an index array's runs of consecutive
# columns from which one slab copy a run stages a block no slower than
# ``np.take``'s copy item by item; below it ``np.take`` is faster (each
# slab copy pays a fixed cost a frame).  Set from a lone-copy probe of
# both on an H100's host, where they tie at 32 (PERF.md §6).
SLAB_MIN_COLUMNS = 32


class _Phase(Span):
    """One use of a named engine phase of pass 2 (a :class:`Span`): its
    host wall time goes into ``engine.phase_times_`` and, as a span
    ``(phase, block, start, end)``, into the run record (``run_trace_``,
    :func:`~sitator_tpu_torch.util.timing.recent_runs`); always on (about
    1 µs a use).  While a profiler records at the run's start, each use is
    also a range ``sitator.pass2.<phase>`` with the argument
    ``block=<first frame>``.  Phases are disjoint on the engine's thread, so
    their sum against the run's wall time splits it into host dwell
    categories: feeder (waiting for the block it hands over), upload
    (gathering a block's columns into the staging buffers and starting the
    copy), snapshot (copying the accumulators before an optimistic fold),
    dispatch_assign, dispatch_fold, drift_fetch, labels_fetch,
    labels_memmap_write (these three of the block being retired),
    epoch_spill (the copy of the device accumulators to the host),
    checkpoint, setup, finalize (these four of no block, -1).  The feeder's
    thread adds a ``read`` span a block around ``reader[lo:hi]``.
    These are host clocks, as in the reference: CUDA calls return before
    the device finishes, so device time shows up in whichever phase waits
    for it.  In the synchronous loop those are drift_fetch and labels_fetch
    of the block just dispatched; with run-ahead they wait only for a block
    dispatched ``pipeline_depth`` blocks earlier, and what device time is
    not hidden moves to wherever the host blocks next: a launch that finds
    the stream's queue full (inside dispatch_fold, which enqueues the
    most), the staging-slot wait in upload, epoch_spill at the end.  The
    card's own time a block is in the run record's ``device`` brackets."""

    __slots__ = ()


def _merge_spans(*tables):
    """Span tables (:meth:`SpanLog.table`) as one, by start time."""
    cat = {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}
    order = np.argsort(cat["start_ns"], kind="stable")
    return {k: v[order] for k, v in cat.items()}


_BRACKETS = ("assign_ms", "fold_ms", "lv_ms")   # by a bracket's kind


def _bracket_ms(brackets):
    """The card's milliseconds of each block's assignment and fold, and of
    the assignment's landmark stage, from their CUDA events ``(block, 0
    assign | 1 fold | 2 landmark stage, start, end)``, summed by block in
    order of first use (a rolled-back block folds again): ``{"block",
    "assign_ms", "fold_ms"}`` arrays, and ``"lv_ms"`` where a landmark
    stage was bracketed, or None without events (a CPU device).  Read once
    the compute stream has passed the events."""
    if not brackets:
        return None
    brackets[-1][3].synchronize()
    rows = {}
    for lo, kind, start, end in brackets:
        rows.setdefault(lo, [0.0, 0.0, 0.0])[kind] += start.elapsed_time(end)
    ms = np.array(list(rows.values()), np.float64).reshape(-1, 3)
    kinds = {kind for _, kind, _, _ in brackets} | {0, 1}
    return dict(block=np.fromiter(rows, np.int64, len(rows)),
                **{_BRACKETS[k]: ms[:, k] for k in sorted(kinds)})


def _pack12(labels):
    """Device-side 12-bit label pack for the egress copy.

    ``labels (B, N)`` int32 in [-1, 4094] are biased by +1 (unknown −1
    becomes 0) and packed 4-per-3 into int16 words: groups of 4 biased
    12-bit values (a, b, c, d) become ``a | b<<12``, ``b>>4 | c<<8``,
    ``c>>8 | d<<4`` (uint16 arithmetic, bit-equal to the reference's words).
    N is zero-padded to a multiple of 4.  Inverse: :func:`_unpack12`."""
    n_frames, n = labels.shape
    v = (labels.to(torch.int32) + 1)
    pad = (-n) % 4
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    a, b, c, d = v.reshape(n_frames, -1, 4).unbind(-1)
    w = torch.stack([a | (b << 12), (b >> 4) | (c << 8), (c >> 8) | (d << 4)],
                    dim=-1) & 0xFFFF
    w = torch.where(w >= 1 << 15, w - (1 << 16), w)   # uint16 bits as int16
    return w.to(torch.int16).reshape(n_frames, -1)


def pack12_width(n_mobile):
    """Egress columns used by the 12-bit pack for ``n_mobile`` labels."""
    return 3 * ((n_mobile + 3) // 4)


def _unpack12(arr, n):
    """Host-side inverse of :func:`_pack12`: the fetched ``(B, 3·⌈n/4⌉)``
    int16 slab → ``(B, n)`` int16 labels with −1 restored for unknown."""
    w = np.ascontiguousarray(arr).view(np.uint16)
    w = w.reshape(arr.shape[0], -1, 3)
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    a = w0 & np.uint16(0xFFF)
    b = (w0 >> 12) | ((w1 & np.uint16(0xFF)) << 4)
    c = (w1 >> 8) | ((w2 & np.uint16(0xF)) << 8)
    d = w2 >> 4
    out = np.stack([a, b, c, d], axis=-1).reshape(arr.shape[0], -1)
    return out[:, :n].astype(np.int16) - np.int16(1)


def _zero_accumulators(K, max_mobile_per_site=None):
    """The pass-2 accumulators for ``K`` sites, zeroed, on the host: integer
    tallies in int64, float sums in float64; row ``K`` of the per-site ones
    collects the unassigned."""
    acc = {
        "occ": torch.zeros(K + 1, dtype=torch.int64),
        "conf": torch.zeros(K + 1, dtype=torch.float64),
        "cos": torch.zeros((K + 1, 3), dtype=torch.float64),
        "sin": torch.zeros((K + 1, 3), dtype=torch.float64),
        "n_ij": torch.zeros((K, K), dtype=torch.int64),
        "lag_sum": torch.zeros((K, K), dtype=torch.int64),
        "res_sum": torch.zeros(K, dtype=torch.int64),
        "res_cnt": torch.zeros(K, dtype=torch.int64),
    }
    if max_mobile_per_site is not None:
        acc["mo_viol"] = torch.zeros((), dtype=torch.int64)
    return acc


def _snapshot(acc):
    """A copy of the accumulators, taken before an optimistic fold (they are
    folded in place) and restored on a rollback."""
    return {k: v.clone() for k, v in acc.items()}


class _Lanes:
    """Host↔device traffic of pass 2 off the compute stream.

    On a CUDA device: frames go up from a ring of pinned staging slots of
    ``slot_frames`` frames on one copy stream, labels and drift come down
    into pinned buffers on a second one, and events order both against the
    compute stream (the current stream), so neither direction makes the
    host wait for queued kernels.  Over a ``mesh`` of several shards each
    shard goes up from its slice of the slot on the upload stream of its
    own device, and its event orders its shard's stream after it.  On a CPU
    device the same calls copy in place and skip the streams and events, so
    one window logic serves both.

    A slot is handed out again only after the uploads last made from it
    have finished (their events), and the ring is longer than the run-ahead
    window, so a block still in flight never shares a slot.

    A host block's columns go into a slot by runs of consecutive columns,
    one strided slab copy a run, where the runs are long enough
    (:meth:`_runs`), else by ``np.take``; the slot holds the same bytes
    either way.  ``stage`` counts the bytes staged each way and the host
    seconds of these copies alone (``slab_bytes``, ``take_bytes``,
    ``copy_s``).

    A block that is a tensor on a device (a reader that hands out frames
    already on the card) takes no slot: its columns are gathered where it
    lies (:meth:`take`).  ``staged`` counts the blocks that went through
    the slots."""

    def __init__(self, device, n_slots, slot_frames, mesh=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slot_frames = slot_frames
        self.mesh = mesh
        self.slots = [{} for _ in range(n_slots)]
        self.cursor = 0
        self.staged = 0
        self.stage = dict(slab_bytes=0, take_bytes=0, copy_s=0.0)
        self.columns = {}       # index arrays on the devices blocks lie on
        self.runs = {}          # runs of host index arrays (:meth:`_runs`)
        self._streams = {}

    def _stream(self, name, device=None):
        """The copy stream ``name`` of ``device`` (default: the engine's),
        created at its first use: a run that never uploads or downloads
        through the lanes (``pipeline_depth=0``) creates none."""
        key = (name, self.device if device is None else device)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(key[1])
        return self._streams[key]

    def upload(self, block, columns):
        """``block[:, idx]`` for each index array of ``columns`` as float32
        frames on the device (frame shards over the mesh): gathered straight
        into the next slot's pinned buffers, copied on the upload stream,
        and made visible to the stream that reads them by an event.  A
        tensor on a card (or any tensor, on a CPU device) takes no slot
        (:meth:`take`): its columns are gathered on its device's current
        stream, which orders them before the kernels that read them, then
        moved to the engine's device by an explicit copy if it lies on
        another card, and split over the mesh.  A CPU tensor bound for a
        card goes through the slots as host frames."""
        if torch.is_tensor(block):
            if not (self.cuda and block.device.type == "cpu"):
                return [self.take(block, idx) for idx in columns]
            block = block.numpy()
        self.staged += 1
        slot = self.slots[self.cursor]
        self.cursor = (self.cursor + 1) % len(self.slots)
        for ev in slot.pop("uploaded", ()):
            ev.synchronize()
        nb = block.shape[0]
        staged = []
        for i, idx in enumerate(columns):
            shape = (self.slot_frames, len(idx), 3)
            buf = slot.get(i)
            if buf is None or buf.shape != shape:
                buf = slot[i] = torch.empty(shape, dtype=torch.float32,
                                            pin_memory=self.cuda)
            view = buf[:nb]
            out = view.numpy()
            runs = self._runs(idx)
            t0 = time.perf_counter()
            if runs is not None:
                for j, a, w in runs:
                    np.copyto(out[:, j:j + w], block[:, a:a + w],
                              casting="unsafe")
            elif block.dtype == np.float32:
                np.take(block, idx, axis=1, out=out, mode="clip")
            else:
                out[...] = block[:, idx]
            self.stage["copy_s"] += time.perf_counter() - t0
            self.stage["take_bytes" if runs is None
                       else "slab_bytes"] += out.nbytes
            staged.append(view)
        if not self.cuda:
            out = [b.clone() for b in staged]
            return out if self.mesh is None else [
                shard_frames(t, self.mesh) for t in out]
        if self.mesh is not None:
            return [self._upload_shards(b, slot) for b in staged]
        compute = torch.cuda.current_stream(self.device)
        up = self._stream("up")
        with torch.cuda.stream(up):
            out = [b.to(self.device, non_blocking=True) for b in staged]
            slot["uploaded"] = [up.record_event()]
        compute.wait_event(slot["uploaded"][0])
        for t in out:   # allocated on the upload stream, used on this one
            t.record_stream(compute)
        return out

    def _runs(self, idx):
        """``idx``'s maximal runs of consecutive increasing columns, as
        ``(slot column, block column, width)``; None where the runs average
        fewer than ``SLAB_MIN_COLUMNS`` columns (an interleaved species
        order, a permuted lattice): there ``np.take`` is the faster copy.
        Found once an index array and kept by its bytes (a remapped lattice
        makes new arrays)."""
        key = (idx.dtype.str, idx.tobytes())
        if key not in self.runs:
            if len(self.runs) >= 8:
                self.runs.clear()
            starts = np.flatnonzero(np.diff(idx, prepend=idx[:1] - 2) != 1)
            widths = np.diff(starts, append=len(idx))
            self.runs[key] = (
                list(zip(starts.tolist(), idx[starts].tolist(),
                         widths.tolist()))
                if len(idx) >= SLAB_MIN_COLUMNS * len(starts) else None)
        return self.runs[key]

    def take(self, block, idx):
        """``block[:, idx]`` as float32 frames on the device (frame shards
        over the mesh) with no staging slot: a tensor's columns gathered on
        its device (:meth:`resident`), a host array's copied from pageable
        memory."""
        if torch.is_tensor(block):
            self.resident(block)
        return place_frames(take_columns(block, idx, self.columns),
                            self.mesh, self.device)

    @staticmethod
    def resident(block):
        """Make a tensor ``block`` on a card safe to read on that card's
        current stream: the feeder thread's reader made it on the card's
        default stream (a thread's current stream until it picks another),
        so where the two differ the current stream waits for the default
        one, and the block's memory is kept from reuse until the current
        stream is done with it."""
        if block.is_cuda:
            made = torch.cuda.default_stream(block.device)
            use = torch.cuda.current_stream(block.device)
            if made != use:
                use.wait_stream(made)
                block.record_stream(use)

    def _upload_shards(self, staged, slot):
        """Frame shards of the pinned ``staged`` block, each copied on the
        upload stream of its shard's device; the events go with the shards
        (:func:`~sitator_tpu_torch.parallel.mesh.shard_map_frames` orders
        each shard's stream after its own)."""
        mesh = self.mesh
        m = staged.shape[0] // mesh.devices.size
        shards, events = [], []
        for i, dev in enumerate(mesh.devices):
            up = self._stream("up", dev)
            with torch.cuda.device(dev), torch.cuda.stream(up):
                shards.append(staged[i * m:(i + 1) * m].to(
                    dev, non_blocking=True))
                events.append(up.record_event())
        slot.setdefault("uploaded", []).extend(events)
        return ShardedFrames(mesh, shards, range(0, staged.shape[0], m),
                             events)

    def mark(self):
        """An event at the compute stream's present end (None on a CPU
        device): what was enqueued so far, and nothing enqueued later.  It
        keeps its time, for the run record's device brackets."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start_download(self, t, produced):
        """Begin copying device tensor ``t`` into a pinned host buffer once
        ``produced`` (a :meth:`mark` taken after the kernels that wrote it)
        has passed, so the copy waits for those kernels only and not for
        work enqueued since; returns a ticket for :meth:`wait`."""
        if not self.cuda:
            return t, None
        down = self._stream("down")
        with torch.cuda.stream(down):
            down.wait_event(produced)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t.record_stream(down)
            return host, down.record_event()

    @staticmethod
    def wait(ticket):
        """The NumPy view of a finished download (blocks until its event)."""
        host, done = ticket
        if done is not None:
            done.synchronize()
        return host.numpy()


def _assign_block(mobile, static, route, *, centers, midpoint, steepness,
                  threshold, cutoff_shape, cell, cell_inv, kcell,
                  static_ref, basis=None, verts=None, vmask=None, A=None,
                  active=None, full_mask=False, want_drift=True,
                  egress="int32", mesh=None):
    """Assign one streamed block: (labels, confs, drift, labels_egress).

    ``route``: 'mxu' (unique-atom kernel K1; ``centers`` column-permuted to
    the kd order of ``basis``), 'gather' (gather kernel K3; ``verts``,
    ``vmask``) or 'dense' (log-space contraction with the membership matrix
    ``A``).  ``want_drift=False`` (guard off) returns None for the drift.
    With ``mesh`` (several shards; ``mobile`` / ``static`` then
    :class:`ShardedFrames`) the assignment and the drift run once per frame
    shard and come back gathered on the mesh's first device.  The egress
    copy of the labels is what leaves the device, in the format ``egress``
    ('pack12' | 'int16' | 'int32', set by the site count in
    :meth:`StreamingLandmarkAnalysis._assign_setup`); the labels themselves
    stay int32 for the accumulators."""

    def local(mobile, static, centers, basis, verts, vmask, A, active,
              static_ref, cell, cell_inv):
        if route == "mxu":
            from sitator_tpu_torch.ops.landmark_mxu import mxu_assign_blocks
            labels, confs = mxu_assign_blocks(
                mobile, static, basis, kcell, centers, midpoint=midpoint,
                steepness=steepness, threshold=threshold,
                cutoff_shape=cutoff_shape)
        elif route == "gather":
            from sitator_tpu_torch.ops.landmark_pallas import \
                fused_assign_blocks
            labels, confs = fused_assign_blocks(
                mobile, static, verts, vmask, kcell, centers,
                midpoint=midpoint, steepness=steepness, threshold=threshold,
                cutoff_shape=cutoff_shape, full_mask=full_mask)
        else:
            lv = lmops.landmark_vectors(mobile, static, A, cell, cell_inv,
                                        midpoint, steepness,
                                        cutoff_shape=cutoff_shape)
            lv_n, _ = lmops.normalize_landmark_vectors(lv)
            labels, confs = lmops.assign_to_centers(lv_n, centers, active,
                                                    threshold)
        drift = (lmops.static_drift_per_frame(static, static_ref, cell,
                                              cell_inv)
                 if want_drift else None)
        return labels, confs, drift

    labels, confs, drift = run_sharded(
        local, mesh, 2, mobile, static, centers, basis, verts, vmask, A,
        active, static_ref, cell, cell_inv, n_outputs=3)
    if egress == "pack12":
        labels_eg = _pack12(labels)
    else:
        labels_eg = labels.to(torch.int16) if egress == "int16" else labels
    return labels, confs, drift, labels_eg


def _accum_block(labels, confs, mobile, cell_inv, valid, carry, acc, *,
                 n_sites, max_mobile=None):
    """Fold one block's assignments into the device accumulators (in
    place); returns the new jump carry.

    ``valid (B,)`` masks the frames that count: invalid frames become
    all-unknown (label −1), which by the jump scan's unknown-frame policy
    neither emits jumps nor advances residences and keeps the carry — so
    block padding and partial folds are exact.  ``carry = (last, res)``
    chains across calls; the returned carry is a new pair of tensors (the
    given one is not written).  Per-site sums go through ``index_add_``
    (atomic adds on the card); slot ``n_sites`` collects the unassigned and
    is the only occupancy count.  The jump tallies go straight into
    ``acc`` through :func:`~sitator_tpu_torch.ops.jumps.jump_fold`: on a
    card one kernel launch, after the sums on the same stream."""
    labels = torch.where(valid[:, None], labels, -1)
    S = n_sites
    known = labels >= 0
    flat = torch.where(known, labels, S).reshape(-1).long()
    w = torch.where(known, confs, 0.0).reshape(-1)
    frac = (mobile.reshape(-1, 3) @ cell_inv) * (2.0 * np.pi)
    acc["occ"].index_add_(0, flat, torch.ones_like(flat))
    acc["conf"].index_add_(0, flat, w.double())
    acc["cos"].index_add_(0, flat, (w[:, None] * torch.cos(frac)).double())
    acc["sin"].index_add_(0, flat, (w[:, None] * torch.sin(frac)).double())
    carry = jump_fold(labels, S, carry, tuple(
        acc[k] for k in ("n_ij", "lag_sum", "res_sum", "res_cnt")))
    if max_mobile is not None:
        # (frame, site) cells holding more than max_mobile assigned ions
        B = labels.shape[0]
        cells = flat.view(B, -1) + (S + 1) * torch.arange(
            B, device=flat.device)[:, None]
        per_fs = torch.zeros(B * (S + 1), dtype=torch.int64,
                             device=flat.device)
        per_fs.index_add_(0, cells.reshape(-1), torch.ones_like(flat))
        acc["mo_viol"] += (per_fs.view(B, S + 1)[:, :S] > max_mobile).sum()
    return carry


class StreamingLandmarkAnalysis:
    """Parameters mirror :class:`LandmarkAnalysis` plus streaming controls:

    block_frames : frames per streamed device block (the last, shorter
        block is computed on its own frames).
    fit_frames : max frames subsampled for the clustering pass.
    fit_max_samples : cap on total (frame, ion) samples in the fit — the
        binding limit for many-ion systems (the landmark-vector matrix is
        ``samples x n_landmarks`` floats).
    store_labels : optional path — labels spill to a memmapped ``.npy`` of
        shape (n_frames, n_mobile).
    checkpoint_path, checkpoint_every : every N blocks the accumulators,
        the jump carry, the frame cursor and the lattice permutation are
        written to an ``.npz`` (the reference's keys); an interrupted run
        resumes from it bit-exactly, and a completed run deletes it.
    max_mobile_per_site, multiple_occupancy_action : 'warn' | 'raise'
        (:class:`MultipleOccupancyError`) | 'ignore' when more ions than that
        share a site in a frame (counted on the device).
    static_movement_threshold : max per-frame static-atom drift (Å) before
        :class:`StaticLatticeError` (None disables the monitor).
    dynamic_lattice_mapping : follow lattice-site exchanges of static atoms
        (the slot→atom permutation is rebuilt at each exchange and the block
        re-assigned from that frame, as in :class:`LandmarkAnalysis`); the
        permutation rides the checkpoint.
    use_fused : 'auto' (the kernels on CUDA) | True | False (dense route).
    pipeline_depth : blocks kept in flight by the optimistic run-ahead
        dispatcher (default 2, as in the reference; 0 is the fully
        synchronous loop).  Each block's upload, assignment and whole-block
        fold are enqueued with no host synchronisation; its drift and
        egress labels are read on the host when it retires,
        ``pipeline_depth`` blocks later.  With the drift guard on, the
        accumulators are copied before each optimistic fold (they are
        folded in place); a drift offender found at retirement restores
        the offender's copy and replays it and every later in-flight block
        through the synchronous path, so labels, tallies, remaps and the
        :class:`StaticLatticeError` are those of ``pipeline_depth=0``
        (``rollbacks_`` counts these events).  Checkpoints drain the window
        first.  Contract: labels, every integer tally, the remaps and the
        checkpoint cursor are identical at every depth; the float64 sums
        (confidence, toroidal centre sums) are identical on a CPU device
        and agree within 1e-12 relative on CUDA, where ``index_add_`` adds
        atomically in arrival order and is not bit-stable from run to run
        at any depth.
    mesh : optional :class:`~sitator_tpu_torch.parallel.mesh.FrameMesh`
        whose first device is ``device``; ``block_frames`` must be a
        multiple of its size.  Pass 2 splits each block into frame shards:
        each shard is uploaded to its device and assigned there (K1, K3 or
        the dense route, with its drift), the labels come back to the first
        device, where the accumulators, the fold and the label egress stay.
        ``fit_centers`` is not sharded (as in the reference) and runs on the
        first device.
    device : torch device the engine runs on (default 'cuda').

    Not in this port: the reference's opt-in ``packed_retire`` (drift
    bit-cast into trailing egress columns, one fetch instead of two at
    retirement) is left out: a fetch here is a copy on its own stream and
    an event wait, and the drift of a block is 1 KB, so there is no round
    trip to save.  Nor are the reference's settings of the retirement and
    the label egress: blocks retire one at a time, a block's labels start
    their copy to the host when it retires, and they leave the device in
    the narrowest format the site count allows (the 12-bit pack below 4096
    sites, int16 below 2^15, else int32), as at the reference's defaults.

    A reader may hand out tensors in place of NumPy blocks: frames already
    on the card stay there (their columns are gathered on the card, with no
    staging slot and no host round trip), frames on another card move to
    ``device`` by an explicit copy.  After a run, ``staged_blocks_`` counts
    the blocks that went up through the pinned staging slots, and
    ``final_state_`` holds the host totals of the accumulators and the
    final jump carry (``carry_last``, ``carry_res``), as a checkpoint
    would.
    """

    def __init__(self, cutoff_midpoint=3.0, cutoff_steepness=4.0,
                 cutoff_shape="logistic",
                 minimum_site_occupancy=0.01, assignment_threshold=None,
                 clustering_params=None, block_frames=1024, fit_frames=8192,
                 fit_max_samples=65536,
                 store_labels=None, mesh=None, checkpoint_path=None,
                 checkpoint_every=64, max_mobile_per_site=1,
                 multiple_occupancy_action="warn",
                 static_movement_threshold=1.0,
                 dynamic_lattice_mapping=False, use_fused="auto",
                 pipeline_depth=2, verbose=True, device="cuda"):
        self.mesh, self.device = bind_mesh(mesh, device)
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.cutoff_shape = cutoff_shape
        self.minimum_site_occupancy = float(minimum_site_occupancy)
        self.clustering_params = dict(clustering_params or {})
        self.assignment_threshold = (
            self.clustering_params.get("assignment_threshold", 0.35)
            if assignment_threshold is None else float(assignment_threshold))
        self.block_frames = int(block_frames)
        self.fit_frames = int(fit_frames)
        self.fit_max_samples = int(fit_max_samples)
        self.store_labels = store_labels
        self.max_mobile_per_site = (
            None if max_mobile_per_site is None else int(max_mobile_per_site))
        if multiple_occupancy_action not in ("warn", "raise", "ignore"):
            raise ValueError("multiple_occupancy_action must be "
                             "'warn' | 'raise' | 'ignore'")
        self.multiple_occupancy_action = multiple_occupancy_action
        self.static_movement_threshold = (
            None if static_movement_threshold is None
            else float(static_movement_threshold))
        self.dynamic_lattice_mapping = bool(dynamic_lattice_mapping)
        if self.dynamic_lattice_mapping and \
                self.static_movement_threshold is None:
            raise ValueError("dynamic_lattice_mapping needs a "
                             "static_movement_threshold")
        self.use_fused = use_fused  # 'auto' | True | False
        self.pipeline_depth = int(pipeline_depth)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.verbose = verbose
        self.n_sites_ = None
        self.gate_ = None

    def _use_fused(self):
        if self.use_fused == "auto":
            return self.device.type == "cuda"
        return bool(self.use_fused)

    def _engine_basis(self, sn, verts, vmask, static_idx):
        """The unique-atom basis on the device, or None when the basis
        shares too few vertices (the gate shared with the other engines,
        its preshift budget tied to the drift guard); the gate's decision
        is kept as ``gate_``."""
        from sitator_tpu_torch.ops.landmark_mxu import (_engine_gate,
                                                        basis_from_jax)
        basis, self.gate_ = _engine_gate(
            verts, vmask, sn.centers, sn.structure.cell,
            midpoint=self.cutoff_midpoint, steepness=self.cutoff_steepness,
            cutoff_shape=self.cutoff_shape,
            static_ref=sn.structure.positions[static_idx],
            drift_budget=self.static_movement_threshold)
        return None if basis is None else (basis,
                                           basis_from_jax(basis, self.device))

    # -- pass 1 --------------------------------------------------------
    def fit_centers(self, sn: SiteNetwork, reader):
        """Cluster centres ``(K, n_landmarks)`` from landmark vectors on an
        evenly strided subsample of ``reader`` (NumPy blocks, or tensors,
        which are stacked and indexed on their own device)."""
        dev = self.device
        n_frames = len(reader)
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        # the sample budget binds for many-ion systems
        n_fit = min(self.fit_frames,
                    max(1, self.fit_max_samples // max(1, len(mobile_idx))))
        stride = max(1, -(-n_frames // n_fit))  # ceil: a hard sample cap
        static_idx = np.flatnonzero(sn.static_mask)
        verts, vmask = sn.padded_vertices()
        cell_np = sn.structure.cell
        cell = torch.as_tensor(cell_np, dtype=torch.float32, device=dev)
        cell_inv = torch.as_tensor(np.linalg.inv(cell_np),
                                   dtype=torch.float32, device=dev)

        # the fit follows lattice-site exchanges too, or the centres would
        # be fit on corrupted landmark vectors for exactly the trajectories
        # dynamic_lattice_mapping targets
        perm = np.arange(len(static_idx))
        if self.dynamic_lattice_mapping:
            from sitator_tpu_torch.landmark.analysis import LandmarkAnalysis
            from sitator_tpu_torch.ops.pbc import PBCCalculator
            calc = PBCCalculator(cell_np)
            ref = np.asarray(sn.structure.positions[static_idx], np.float64)
            thr = self.static_movement_threshold

        # the fit needs landmark VECTORS, which the lv-emitting unique-atom
        # kernel (K2) gives under the same gate as pass 2
        fit_basis = (self._engine_basis(sn, verts, vmask, static_idx)
                     if self._use_fused() else None)
        if fit_basis is not None:
            from sitator_tpu_torch.ops.kernel_common import kernel_cell
            from sitator_tpu_torch.ops.landmark_mxu import mxu_landmark_blocks
            kcell = kernel_cell(cell_np)
        else:
            A = lmops.vertex_membership_matrix(verts, vmask,
                                               len(static_idx)).to(dev)

        lvs = []
        B = 256
        sel = np.arange(0, n_frames, stride)
        columns = {}
        for lo in range(0, len(sel), B):
            rows = [reader[int(i):int(i) + 1][0] for i in sel[lo:lo + B]]
            if torch.is_tensor(rows[0]):
                frames = torch.stack(rows)
                if self.dynamic_lattice_mapping:  # remapped on the host
                    frames = frames.cpu().numpy()
            else:
                frames = np.stack(rows)
            static_np = take_columns(frames, static_idx, columns)
            if self.dynamic_lattice_mapping:
                static_np = static_np.copy()
                for b in range(len(static_np)):
                    d = calc.paired_distances(static_np[b][perm], ref)
                    if (d > thr).any():
                        new_perm, worst = \
                            LandmarkAnalysis._find_lattice_mapping(
                                static_np[b], perm, ref, cell_np, thr)
                        if new_perm is None:
                            raise StaticLatticeError(
                                "no consistent lattice mapping at "
                                f"subsampled frame {int(sel[lo + b])}: "
                                f"residual {worst:.3f} Å > threshold "
                                f"{thr} Å", frame=int(sel[lo + b]),
                                max_drift=worst)
                        perm = new_perm
                    static_np[b] = static_np[b][perm]
            mobile = place_frames(take_columns(frames, mobile_idx, columns),
                                  None, dev)
            static = place_frames(static_np, None, dev)
            if fit_basis is not None:
                lv = mxu_landmark_blocks(
                    mobile, static, fit_basis[1], kcell,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape)
            else:
                lv = lmops.landmark_vectors(
                    mobile, static, A, cell, cell_inv, self.cutoff_midpoint,
                    self.cutoff_steepness, cutoff_shape=self.cutoff_shape)
            lv_n, _ = lmops.normalize_landmark_vectors(lv)
            lvs.append(lv_n.reshape(-1, lv_n.shape[-1]))
        X = torch.cat(lvs)
        del lvs
        p = {"clustering_threshold": 0.45, "k_max": 512, "n_refine_iters": 10,
             **self.clustering_params}
        min_samples = max(1, int(np.ceil(
            self.minimum_site_occupancy * len(sel))))
        res = dotprod_fit(X, k_max=p["k_max"],
                          cluster_threshold=p["clustering_threshold"],
                          min_samples=min_samples,
                          n_iters=p["n_refine_iters"])
        centers = res["centers"][res["active"]].cpu().numpy()
        if self.verbose:
            logger.info("streaming fit: %d sites from %d subsampled frames",
                        len(centers), len(sel))
        return centers

    # -- pass 2 --------------------------------------------------------
    def _assign_setup(self, sn, centers, mesh=None):
        """Pass 2's kernel route and the keyword arguments of
        :func:`_assign_block` for ``centers (K, n_landmarks)`` on the
        engine's device: K1 ('mxu') when the basis shares vertices, else K3
        ('gather'), the dense route when the kernels are off."""
        dev = self.device
        K = len(centers)
        static_idx = np.flatnonzero(sn.static_mask)
        verts, vmask = sn.padded_vertices()
        cell_np = sn.structure.cell
        route = "dense"
        self.gate_ = None
        plan = dict(centers=torch.as_tensor(centers, device=dev))
        if self._use_fused():
            route = "gather"
            plan.update(verts=torch.as_tensor(verts, device=dev),
                        vmask=torch.as_tensor(vmask, device=dev),
                        full_mask=bool(np.asarray(vmask).all()))
            basis = self._engine_basis(sn, verts, vmask, static_idx)
            if basis is not None:
                from sitator_tpu_torch.ops.landmark_mxu import permute_centers
                route = "mxu"
                plan = dict(basis=basis[1], centers=torch.as_tensor(
                    permute_centers(centers, basis[0]), device=dev))
        else:
            # the dense membership matrix exists only on the dense route
            plan.update(A=lmops.vertex_membership_matrix(
                verts, vmask, len(static_idx)).to(dev),
                active=torch.ones(K, dtype=torch.bool, device=dev))
        from sitator_tpu_torch.ops.kernel_common import kernel_cell
        # the narrowest egress the labels fit: the 12-bit pack holds labels
        # up to 4094 (biased by one), and int16 must never wrap a site index
        egress = ("pack12" if K < 4096 else
                  "int16" if K < (1 << 15) else "int32")
        return route, dict(
            midpoint=self.cutoff_midpoint, steepness=self.cutoff_steepness,
            threshold=self.assignment_threshold,
            cutoff_shape=self.cutoff_shape,
            cell=torch.as_tensor(cell_np, dtype=torch.float32, device=dev),
            cell_inv=torch.as_tensor(np.linalg.inv(cell_np),
                                     dtype=torch.float32, device=dev),
            kcell=kernel_cell(cell_np),
            static_ref=torch.as_tensor(sn.structure.positions[static_idx],
                                       dtype=torch.float32, device=dev),
            want_drift=self.static_movement_threshold is not None,
            egress=egress, mesh=mesh, **plan)

    def run(self, sn: SiteNetwork, trajectory, centers=None):
        """``trajectory``: a TrajectoryReader (of NumPy blocks or tensors)
        or an (F, A, 3) array.  Returns an annotated SiteNetwork (the
        streaming result object).

        The run is measured as it goes, at the cost of a few array writes
        a phase and four CUDA events a block: ``phase_times_`` (host
        seconds by phase, :class:`_Phase`) and ``run_trace_``, the run
        record, also kept process-wide by
        :func:`~sitator_tpu_torch.util.timing.recent_runs` (its keys are
        documented there): every phase use as a span with its block (the
        block's first frame), the feeder thread's reads, the card's
        milliseconds of each block's assignment, its landmark stage and
        its fold, the fused-route gate's decision, the upload's staging
        of blocks into its pinned slots (bytes by route, copy seconds),
        and the I/O pool's decode tasks and thread-seconds.  Under a
        ``torch.profiler`` session opened before the call
        (``util.timing.device_trace``) the spans are ranges
        ``sitator.pass2.<phase>`` with ``block=<lo>``; the check is made
        once, at the call."""
        reader = (trajectory if hasattr(trajectory, "__getitem__")
                  and not isinstance(trajectory, np.ndarray)
                  else ArrayTrajectory(np.asarray(trajectory)))
        n_frames = len(reader)
        n_dev = 1 if self.mesh is None else self.mesh.devices.size
        if self.block_frames % n_dev:
            raise ValueError(
                "block_frames must be a multiple of the mesh size")
        # the mesh's shards when there are several (a one-device mesh runs
        # the unsharded path)
        smesh = self.mesh if n_dev > 1 else None
        if centers is None:
            centers = self.fit_centers(sn, reader)
        centers = np.asarray(centers, np.float32)
        K = len(centers)
        self.n_sites_ = K
        dev = self.device
        pt = self.phase_times_ = {}
        offset = clock_offset_ns()
        profiled = profiler_recording()
        log = SpanLog(offset, profiled)
        read_log = SpanLog(offset, profiled)     # the feeder thread's
        decode0 = pool_counters()
        t_run = time.perf_counter_ns()

        def ph(name, block=NO_BLOCK):
            return _Phase(pt, name, block, log)

        _setup = ph("setup")   # basis prep, checkpoint probe, memmap
        _setup.__enter__()

        mobile_idx = np.flatnonzero(sn.mobile_mask)
        static_idx = np.flatnonzero(sn.static_mask)
        n_mobile = len(mobile_idx)
        cell_np = sn.structure.cell
        route, assign_kw = self._assign_setup(sn, centers, smesh)
        self.route_ = route
        cell_inv = assign_kw["cell_inv"]
        pack12 = assign_kw["egress"] == "pack12"

        start_lo = 0
        carry_np = (np.full((n_mobile,), -1, np.int64),
                    np.zeros((n_mobile,), np.int64))
        static_ref_np = np.asarray(sn.structure.positions[static_idx],
                                   np.float64)
        perm = np.arange(len(static_idx))
        n_remaps = 0
        host_acc = {}

        # resume from a mid-run checkpoint if one exists
        ckpt = self.checkpoint_path
        if ckpt is not None and os.path.exists(ckpt):
            with np.load(ckpt) as d:
                if int(d["n_frames"]) != n_frames or int(d["K"]) != K:
                    raise ValueError("checkpoint does not match this run")
                start_lo = int(d["next_lo"])
                carry_np = (d["carry_last"].astype(np.int64),
                            d["carry_res"].astype(np.int64))
                if "perm" in d.files:
                    perm = d["perm"].copy()
                host_acc = {k[5:]: d[k].copy() for k in d.files
                            if k.startswith("hacc/")}
            if self.verbose:
                logger.info("resuming streaming run at frame %d", start_lo)

        jumps0 = int(np.sum(host_acc.get("res_cnt", 0)))   # resumed
        folds0 = jump_fold.launches
        lv0 = (_cuda.lv_tile.rows_launches, _cuda.lv_tile.f32_launches)
        acc = _zero_accumulators(K, self.max_mobile_per_site)
        for k, v in host_acc.items():
            if k in acc:
                acc[k] += torch.as_tensor(np.asarray(v)).to(acc[k].dtype)
        acc = {k: v.to(dev) for k, v in acc.items()}
        carry = tuple(torch.as_tensor(c, device=dev) for c in carry_np)

        labels_out = None
        if self.store_labels is not None:
            mode = "r+" if (ckpt is not None and start_lo > 0
                            and os.path.exists(self.store_labels)) else "w+"
            labels_out = np.lib.format.open_memmap(
                self.store_labels, mode=mode, dtype=np.int32,
                shape=(n_frames, n_mobile))

        B = self.block_frames
        thr_drift = self.static_movement_threshold

        W = max(0, self.pipeline_depth)
        lanes = _Lanes(dev, W + 2 if W else 0, B, smesh)
        frame_ids = torch.arange(B, device=dev)
        self.rollbacks_ = 0
        brackets = []   # (block, 0 assign | 1 fold, start event, end event)

        def fetch_labels(lo, box):
            """Host copy of one assignment's egress labels, fetched at most
            once per assignment and decoded."""
            if box["np"] is None:
                with ph("labels_fetch", lo):
                    arr = (box["dev"].cpu().numpy() if box["copy"] is None
                           else lanes.wait(box["copy"]))
                box["np"] = _unpack12(arr, n_mobile) if pack12 else arr
            return box["np"]

        def write_labels(lo, a, b, box):
            """Spill frames [a, b) of a block's labels to the memmap."""
            if labels_out is None:
                return
            lab = fetch_labels(lo, box)
            with ph("labels_memmap_write", lo):
                labels_out[lo + a:lo + b] = lab[a:b]

        def valid_frames(n, a, b):
            """The mask of frames [a, b) of an ``n``-frame block."""
            ids = frame_ids[:n]
            return (ids >= a) & (ids < b)

        def full(frames):
            """A block's frames whole on the device: gathered from their
            shards over the mesh."""
            if isinstance(frames, ShardedFrames):
                return gather_frames(frames, dev)
            return frames

        def fold(lo, a, b, labels, confs, mobile, start=None):
            """Fold frames [a, b) of the assignment of the block at ``lo``
            (``mobile``: the block's ion frames, whole); its device bracket
            starts at ``start`` (an event after the assignment) or now."""
            nonlocal carry
            with ph("dispatch_fold", lo):
                if start is None:
                    start = lanes.mark()
                carry = _accum_block(
                    labels, confs, mobile, cell_inv,
                    valid_frames(labels.shape[0], a, b), carry, acc,
                    n_sites=K, max_mobile=self.max_mobile_per_site)
                if start is not None:
                    brackets.append((lo, 1, start, lanes.mark()))

        def static_columns():
            return static_idx[perm] if self.dynamic_lattice_mapping \
                else static_idx

        def upload_static(lo, block):
            with ph("upload", lo):
                return lanes.take(block, static_columns())

        def assign(lo, mobile, static):
            """The assignment of the block at ``lo``, the box its egress
            labels are fetched through, and an event at its end (None on a
            CPU device)."""
            lv_end = []     # the landmark stage's first mark (one device)

            def lv_done():
                if not lv_end and smesh is None:
                    lv_end.append(lanes.mark())
            with ph("dispatch_assign", lo):
                start = lanes.mark()
                with stage_marks(lv_done):
                    out = _assign_block(mobile, static, route, **assign_kw)
                end = lanes.mark()
            if end is not None:
                brackets.append((lo, 0, start, end))
                if lv_end:
                    brackets.append((lo, 2, start, lv_end[0]))
            return out, {"np": None, "dev": out[3], "copy": None}, end

        def process_block(lo, block, nb, mobile, pre=None):
            """The synchronous per-block path: per-frame drift gating,
            lattice remapping, partial folds.  ``pre = (labels, confs,
            drift_f, box)`` reuses an existing assignment of the block and
            its host drift: valid only while ``perm`` is unchanged since it
            was made."""
            nonlocal perm, n_remaps
            mobile_full = full(mobile)
            processed = 0
            last_remap = (-1, 0)
            need_assign = pre is None
            if pre is not None:
                labels, confs, drift_f, box = pre
            while processed < nb:
                if need_assign:
                    # (re)assign the whole block — on entry and after a
                    # slot→atom permutation change; labels are fetched
                    # lazily after the first accumulator dispatch
                    (labels, confs, drift, _), box, _ = assign(
                        lo, mobile, upload_static(lo, block))
                    if thr_drift is not None:
                        with ph("drift_fetch", lo):
                            drift_f = drift[:nb].cpu().numpy()
                    need_assign = False
                stop = nb
                if thr_drift is not None:
                    off = np.flatnonzero(drift_f[processed:] > thr_drift)
                    if len(off):
                        if not self.dynamic_lattice_mapping:
                            raise StaticLatticeError(
                                f"a static-lattice atom drifted "
                                f"{float(drift_f[processed + off[0]]):.3f} Å "
                                f"(> threshold {thr_drift} Å) at frame "
                                f"{lo + processed + int(off[0])}; see "
                                "dynamic_lattice_mapping for "
                                "site-exchanging lattices",
                                frame=lo + processed + int(off[0]))
                        stop = processed + int(off[0])
                if stop > processed:
                    fold(lo, processed, stop, labels, confs, mobile_full)
                    write_labels(lo, processed, stop, box)
                if stop < nb:
                    # a few remap attempts are allowed at one frame; any
                    # progress resets the count
                    if lo + stop == last_remap[0]:
                        if last_remap[1] >= 3:
                            raise StaticLatticeError(
                                "lattice remapping did not converge at "
                                f"frame {lo + stop}", frame=lo + stop)
                        last_remap = (lo + stop, last_remap[1] + 1)
                    else:
                        last_remap = (lo + stop, 1)
                    from sitator_tpu_torch.landmark.analysis import \
                        LandmarkAnalysis
                    frame = block[stop]
                    if torch.is_tensor(frame):
                        frame = frame.cpu().numpy()
                    new_perm, worst = LandmarkAnalysis._find_lattice_mapping(
                        frame[static_idx], perm, static_ref_np, cell_np,
                        thr_drift)
                    if new_perm is None:
                        raise StaticLatticeError(
                            f"no consistent lattice mapping at frame "
                            f"{lo + stop}: residual {worst:.3f} Å > "
                            f"threshold {thr_drift} Å", frame=lo + stop,
                            max_drift=worst)
                    if np.array_equal(new_perm, perm):
                        # the f32 device drift grazed the threshold but the
                        # f64 check finds no offender: accept the frame;
                        # the assignment stays valid (perm unchanged)
                        fold(lo, stop, stop + 1, labels, confs,
                             mobile_full)
                        write_labels(lo, stop, stop + 1, box)
                        processed = stop + 1
                        continue
                    if self.verbose:
                        logger.info(
                            "frame %d: lattice site exchange — remapped %d "
                            "slots (max residual %.3f Å)", lo + stop,
                            int((new_perm != perm).sum()), worst)
                    perm = new_perm
                    n_remaps += 1
                    need_assign = True
                processed = stop

        # --- optimistic run-ahead (the dispatch pipeline) ---------------
        # The synchronous path reads a block's drift back between its
        # assignment and its fold, so the host waits for the device twice a
        # block and the device idles while the host dispatches.  The fast
        # path enqueues upload, assignment and the whole-block fold at once
        # and keeps up to ``pipeline_depth`` blocks in flight; drift and
        # labels are read when a block RETIRES, after its kernels have
        # finished.  Exactness: the fold is optimistic.  The accumulators
        # are folded in place, so with the drift guard on they are copied
        # before each fold (no other event rolls back; the carry tensors
        # are replaced, not written, and need no copy).  If retirement
        # finds a drift offender, the copy is restored and the offending
        # block and every later in-flight block go through the synchronous
        # path, which reproduces the never-pipelined behaviour (same perm,
        # same kernels, same folds).  Checkpoints drain the window first,
        # so no optimistic state reaches a snapshot.
        window = []

        def dispatch(lo, block, nb):
            """Enqueue one block with no host synchronisation."""
            nonlocal carry
            with ph("upload", lo):
                mobile, static = lanes.upload(
                    block, (mobile_idx, static_columns()))
            snap = None
            if thr_drift is not None:
                with ph("snapshot", lo):
                    snap = (carry, _snapshot(acc))
            (labels, confs, drift, _), box, assigned = assign(lo, mobile,
                                                              static)
            fold(lo, 0, nb, labels, confs, full(mobile), start=assigned)
            window.append(dict(lo=lo, nb=nb, block=block, mobile=mobile,
                               labels=labels, confs=confs, drift=drift,
                               box=box, snap=snap, assigned=assigned))

        def retire():
            """Retire the oldest in-flight block: its drift and egress
            labels start their downloads, and a drift offender rolls the
            accumulators back to its pre-block copy and replays it and
            every later in-flight block through the synchronous path."""
            nonlocal carry, acc
            e = window.pop(0)
            ticket = (lanes.start_download(e["drift"], e["assigned"])
                      if thr_drift is not None else None)
            if labels_out is not None:
                e["box"]["copy"] = lanes.start_download(e["box"]["dev"],
                                                        e["assigned"])
            drift = None
            if ticket is not None:
                with ph("drift_fetch", e["lo"]):
                    drift = lanes.wait(ticket)[:e["nb"]]
            if drift is None or not (drift > thr_drift).any():
                write_labels(e["lo"], 0, e["nb"], e["box"])
                return
            # rollback: restore the offender's pre-block copy and replay it
            # and every later in-flight block synchronously (raises
            # StaticLatticeError or remaps, exactly like the synchronous
            # engine).  The offender's assignment predates any remap and is
            # reused; later blocks re-assign under the updated permutation.
            self.rollbacks_ += 1
            carry, acc = e["snap"]
            redo = [e] + window
            window.clear()
            for i, r in enumerate(redo):
                process_block(
                    r["lo"], r["block"], r["nb"], r["mobile"],
                    pre=(r["labels"], r["confs"], drift, r["box"])
                    if i == 0 else None)

        def drain():
            while window:
                retire()

        def host_totals():
            with ph("epoch_spill"):
                return {k: v.cpu().numpy() for k, v in acc.items()}

        blocks_done = 0
        read_pt = {}
        feeder = iter(get_progress_bar(
            ChunkedFeeder(reader, B, start=start_lo,
                          span=lambda lo: Span(read_pt, "read", lo,
                                               read_log)),
            enabled=self.verbose, total=-(-(n_frames - start_lo) // B),
            desc="streaming", unit="block"))
        _setup.__exit__()
        next_lo = start_lo
        while True:
            # the wait for the block the feeder hands over next (the last
            # wait, for the feeder's end, is of no block)
            with ph("feeder", next_lo if next_lo < n_frames else NO_BLOCK):
                item = next(feeder, None)
            if item is None:
                break
            lo, block = item
            next_lo = lo + B
            nb = len(block)
            # a short block runs on its own frames, padded only up to a
            # multiple of the mesh size (the padding is masked out)
            block, _ = pad_frames(block, n_dev)
            if W == 0:
                with ph("upload"):
                    mobile = lanes.take(block, mobile_idx)
                process_block(lo, block, nb, mobile)
            else:
                dispatch(lo, block, nb)
                while len(window) > W:
                    retire()
            blocks_done += 1
            if ckpt is not None and blocks_done % self.checkpoint_every == 0:
                # in-flight blocks must retire (or roll back) before their
                # statistics can reach a checkpoint
                drain()
                totals = host_totals()
                with ph("checkpoint"):
                    self._save_checkpoint(ckpt, n_frames, K, lo + nb, carry,
                                          totals, perm)

        drain()
        totals = host_totals()   # the compute stream is done here
        device_ms = _bracket_ms(brackets)
        self.final_state_ = dict(
            totals, carry_last=carry[0].cpu().numpy(),
            carry_res=carry[1].cpu().numpy())
        self.staged_blocks_ = lanes.staged
        if n_remaps and self.verbose:
            logger.info("dynamic lattice mapping: %d slot→atom remaps",
                        n_remaps)
        self.lattice_mapping_ = perm if self.dynamic_lattice_mapping else None
        if ckpt is not None and os.path.exists(ckpt):
            os.remove(ckpt)  # run completed; checkpoint no longer needed
        self._check_multiple_occupancy(totals, n_frames)
        with ph("finalize"):
            out = self._finalize(sn, centers, totals, n_frames, labels_out)
        wall_ns = time.perf_counter_ns() - t_run
        names = list(log.names)
        decode1 = pool_counters()
        self.run_trace_ = dict(
            phases=names, spans=_merge_spans(log.table(names),
                                             read_log.table(names)),
            blocks=np.arange(start_lo, n_frames, B, dtype=np.int64),
            clock_offset_ns=offset, device=device_ms, gate=self.gate_,
            decode=dict(tasks=decode1[0] - decode0[0],
                        busy_s=decode1[1] - decode0[1], threads=N_THREADS),
            fold=dict(launches=jump_fold.launches - folds0,
                      jumps=int(totals["res_cnt"].sum()) - jumps0),
            lv_tile=dict(rows=_cuda.lv_tile.rows_launches - lv0[0],
                         f32=_cuda.lv_tile.f32_launches - lv0[1]),
            stage=dict(lanes.stage),
            frames=n_frames - start_lo, block_frames=B,
            start_ns=t_run + offset, wall_s=wall_ns * 1e-9,
            profiled=profiled)
        record_run(self.run_trace_)
        return out

    def _check_multiple_occupancy(self, host_acc, n_frames):
        n_viol = int(host_acc.get("mo_viol", 0))
        if n_viol == 0 or self.multiple_occupancy_action == "ignore":
            return
        msg = (f"{n_viol} (frame, site) occupancies exceed "
               f"max_mobile_per_site={self.max_mobile_per_site} over "
               f"{n_frames} frames — sites may be under-resolved")
        if self.multiple_occupancy_action == "raise":
            raise MultipleOccupancyError(msg, count=n_viol)
        logger.warning(msg)

    # -- streaming post-merge -------------------------------------------
    @staticmethod
    def merge_network(sn, inflation=2.0, distance_threshold=3.0,
                      verbose=True, device="cuda"):
        """Merge over-split sites of a *streamed* result network using its
        accumulated ``n_ij`` (MCL on the jump graph, like
        ``MergeSitesByDynamics``, on ``device``) — but at the statistics
        level, since the label matrix may never be memory-resident: hop
        counts and occupancy-style attributes are group-summed; intra-group
        hops (flickers between split halves) drop out of ``n_ij``.

        Returns ``(merged_network, remap)`` where ``remap[j]`` is the new
        index of old site ``j`` — apply to spilled labels lazily.

        Note: residence-style attributes cannot be exactly reconstituted
        from summed statistics (a flicker inside a merged group should have
        been one continuous residence); they are dropped.  Re-run
        JumpAnalysis on remapped labels where exact residences matter.
        """
        from sitator_tpu_torch.network.merging import _components
        from sitator_tpu_torch.ops.mcl import markov_cluster
        from sitator_tpu_torch.ops.pbc import PBCCalculator

        n_ij = np.asarray(sn.n_ij, dtype=np.float64)
        T = n_ij + n_ij.T
        T[np.diag_indices_from(T)] += np.maximum(T.max(axis=1), 1.0)
        groups = markov_cluster(T, inflation=inflation, device=device)
        calc = PBCCalculator(sn.structure.cell)
        occ = np.asarray(sn.occupancies)

        # distance guard: single-linkage split within each group
        final = []
        for g in groups:
            g = np.asarray(g)
            if len(g) == 1 or distance_threshold is None:
                final.append(g)
                continue
            d = calc.pairwise_distances(sn.centers[g])
            final.extend(g[c] for c in _components(d <= distance_threshold))
        final.sort(key=lambda g: int(g.min()))

        S = sn.n_sites
        remap = np.empty(S, dtype=np.int32)
        for k, g in enumerate(final):
            remap[g] = k
        K2 = len(final)
        centers = np.empty((K2, 3))
        for k, g in enumerate(final):
            w = occ[g]
            centers[k] = calc.average(sn.centers[g],
                                      w if w.sum() > 0 else None)
        n_ij2 = np.zeros((K2, K2), dtype=np.int64)
        idx_i = np.broadcast_to(remap[:, None], (S, S))
        idx_j = np.broadcast_to(remap[None, :], (S, S))
        np.add.at(n_ij2, (idx_i, idx_j), n_ij.astype(np.int64))
        np.fill_diagonal(n_ij2, 0)  # intra-group hops were flickers
        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = centers
        out.add_site_attribute("occupancies",
                               np.bincount(remap, weights=occ,
                                           minlength=K2))
        out.add_edge_attribute("n_ij", n_ij2)
        row = n_ij2.sum(1, keepdims=True)
        out.add_edge_attribute(
            "p_ij", np.where(row > 0, n_ij2 / np.maximum(row, 1), 0.0))
        if verbose:
            logger.info("merge_network: %d -> %d sites, %d -> %d jumps",
                        S, K2, int(n_ij.sum()), int(n_ij2.sum()))
        return out, remap

    @staticmethod
    def _save_checkpoint(path, n_frames, K, next_lo, carry, host_acc,
                         perm=None):
        """Snapshot the run: int64/float64 totals, the jump carry and the
        lattice slot→atom permutation, under the reference's keys.  Written
        atomically."""
        tmp = path + ".tmp"
        extra = {} if perm is None else {"perm": np.asarray(perm)}
        carry = [c.cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
                 for c in carry]
        with open(tmp, "wb") as f:
            np.savez(f, n_frames=n_frames, K=K, next_lo=next_lo,
                     carry_last=carry[0], carry_res=carry[1], **extra,
                     **{f"hacc/{k}": np.asarray(v)
                        for k, v in host_acc.items()})
        os.replace(tmp, path)  # atomic: a crash never corrupts the ckpt

    def _finalize(self, sn, centers, acc, n_frames, labels_out):
        K = len(centers)
        occ = acc["occ"][:K].astype(np.float64)
        # toroidal mean -> fractional coords -> cartesian
        theta = np.arctan2(acc["sin"][:K], acc["cos"][:K])
        frac = (theta / (2 * np.pi)) % 1.0
        site_centers = frac @ sn.structure.cell

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = site_centers
        out.add_site_attribute("occupancies", occ / n_frames)
        n_ij = acc["n_ij"].astype(np.int64)
        out.add_edge_attribute("n_ij", n_ij)
        row = n_ij.sum(1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            out.add_edge_attribute(
                "p_ij", np.where(row > 0, n_ij / np.maximum(row, 1), 0.0))
            out.add_edge_attribute(
                "jump_lag", np.where(n_ij > 0,
                                     acc["lag_sum"] / np.maximum(n_ij, 1),
                                     np.nan))
            out.add_site_attribute(
                "residence_times",
                np.where(acc["res_cnt"] > 0,
                         acc["res_sum"] / np.maximum(acc["res_cnt"], 1),
                         np.nan))
        out.add_site_attribute("total_corrected_residences",
                               acc["occ"][:K].astype(np.int64))
        self.labels_ = labels_out
        if self.verbose:
            logger.info("streaming run: %d frames, %d sites, %d jumps",
                        n_frames, K, int(n_ij.sum()))
        return out
