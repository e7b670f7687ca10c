"""Stage timing + profiling hooks (counterpart of
``sitator_tpu.util.timing``).

A structured per-stage timing report, and optional ``torch.profiler`` trace
capture around any stage (the reference captures ``jax.profiler`` traces).
The trace records the host's operators and, when a CUDA device is present,
the card's kernels and copies; it is written under ``trace_dir`` as a
Chrome trace (``*.pt.trace.json``), which TensorBoard's profiler plugin and
Perfetto read.

The engines' own instrument lives here too.  :class:`Span` is one use of a
named host phase: its wall time is added to a dict of totals (what
``StreamingLandmarkAnalysis.phase_times_`` holds) and, given a
:class:`SpanLog`, logged as ``(phase, block, start, end)``.  While a
profiler records (checked once per run, :func:`profiler_recording`), each
span is also a ``record_function`` range named ``sitator.pass2.<phase>``
with the argument ``block=<first frame>``, so a trace shows the engine's
phases block by block.  A finished pass 2 leaves its run record on the
engine (``run_trace_``) and in :func:`recent_runs`, the last
``RECENT_RUNS`` records of the process, newest last: how code that holds
no engine, such as a long-lived analysis process, reads a run.

:func:`stage_marks` and :func:`stage_mark` let a caller bracket the
landmark stage of an assignment it does not launch itself: the kernel
wrappers call ``stage_mark()`` once the stage's last kernel is enqueued,
and the engine, which opened ``stage_marks`` around its assignment, records
a CUDA event there.  Outside ``stage_marks`` a mark costs one attribute
lookup.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

logger = logging.getLogger(__name__)

RANGE_PREFIX = "sitator.pass2."   # profiler ranges of the engine's spans
NO_BLOCK = -1                     # the block id of a span of no block
RECENT_RUNS = 8

_recent = collections.deque(maxlen=RECENT_RUNS)
_recent_lock = threading.Lock()
_stage = threading.local()


class StageTimer:
    """Collects named wall-clock stages; ``report()`` returns/logs a table.

    >>> t = StageTimer()
    >>> with t.stage("landmark"):
    ...     ...
    >>> print(t.report())
    """

    def __init__(self, name="pipeline"):
        self.name = name
        self.stages = []  # (name, seconds)

    @contextlib.contextmanager
    def stage(self, name, trace_dir=None):
        ctx = (contextlib.nullcontext() if trace_dir is None
               else device_trace(trace_dir))
        t0 = time.perf_counter()
        with ctx:
            yield
        self.stages.append((name, time.perf_counter() - t0))

    @property
    def total(self):
        return sum(s for _, s in self.stages)

    def report(self, log=False):
        width = max((len(n) for n, _ in self.stages), default=5)
        lines = [f"{self.name} timing:"]
        for n, s in self.stages:
            pct = 100.0 * s / self.total if self.total else 0.0
            lines.append(f"  {n:<{width}}  {s:9.3f}s  {pct:5.1f}%")
        lines.append(f"  {'TOTAL':<{width}}  {self.total:9.3f}s")
        out = "\n".join(lines)
        if log:
            logger.info("%s", out)
        return out


@contextlib.contextmanager
def device_trace(trace_dir):
    """Capture a ``torch.profiler`` trace of the block into ``trace_dir``
    (host operators of every thread, with the engines' phase ranges, plus
    the card's activity when CUDA is available).  The card's work is
    synchronised before the trace closes, so its last kernels are in it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, experimental_config=_all_threads(),
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
        if cuda:
            torch.cuda.synchronize()


def _all_threads():
    """The profiler's option to record every thread's ranges (the trajectory
    feeder's ``read`` spans run on a thread of their own), or None where
    this PyTorch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def profiler_recording():
    """Whether a ``torch.profiler`` session records: on this thread, or on
    every thread (then only the profiler's module says so)."""
    return (torch._C._autograd._profiler_enabled()
            or getattr(torch.autograd.profiler, "_is_profiler_enabled",
                       False))


def clock_offset_ns():
    """What turns ``time.perf_counter_ns()`` into the profiler's clock
    (Unix-epoch nanoseconds)."""
    return time.time_ns() - time.perf_counter_ns()


class SpanLog:
    """Spans ``(phase, block, start, end)`` written by one thread, in int64
    columns that double when full; stamps on the profiler's clock
    (``perf_counter_ns() + offset_ns``).  ``profiled``: open a profiler
    range for each span."""

    def __init__(self, offset_ns, profiled=False, capacity=64):
        self.offset_ns = int(offset_ns)
        self.profiled = bool(profiled)
        self.names = []
        self.ids = {}
        self.total_ns = []
        self.n = 0
        self.cols = np.empty((4, capacity), np.int64)

    def add(self, name, block, t0, t1):
        """Log one span of ``name`` from ``t0`` to ``t1`` (perf_counter_ns);
        returns the phase's total nanoseconds so far."""
        i = self.ids.get(name)
        if i is None:
            i = self.ids[name] = len(self.names)
            self.names.append(name)
            self.total_ns.append(0)
        n = self.n
        if n == self.cols.shape[1]:
            self.cols = np.concatenate([self.cols, np.empty_like(self.cols)],
                                       axis=1)
        self.cols[:, n] = (i, block, t0 + self.offset_ns, t1 + self.offset_ns)
        self.n = n + 1
        self.total_ns[i] += t1 - t0
        return self.total_ns[i]

    def table(self, names):
        """The spans as ``{"phase", "block", "start_ns", "end_ns"}`` arrays,
        the phase an index into ``names`` (which gains this log's names)."""
        remap = np.empty(len(self.names), np.int64)
        for i, name in enumerate(self.names):
            if name not in names:
                names.append(name)
            remap[i] = names.index(name)
        c = self.cols[:, :self.n]
        return dict(phase=remap[c[0]], block=c[1].copy(),
                    start_ns=c[2].copy(), end_ns=c[3].copy())


class Span:
    """One use of the named phase ``name`` (a context manager): its host
    wall time is added to ``totals[name]`` in seconds; with a :class:`SpanLog`
    it is logged with ``block`` (the block's first frame, :data:`NO_BLOCK`
    for none), ``totals[name]`` is then the phase's logged total, and while
    the log is ``profiled`` the span is a profiler range
    ``sitator.pass2.<name>`` with the argument ``block=<block>``.  About
    1 µs a use without a profiler."""

    __slots__ = ("totals", "name", "block", "log", "t0", "range_")

    def __init__(self, totals, name, block=NO_BLOCK, log=None):
        self.totals = totals
        self.name = name
        self.block = block
        self.log = log
        self.range_ = None

    def __enter__(self):
        if self.log is not None and self.log.profiled:
            self.range_ = record_function(RANGE_PREFIX + self.name,
                                          f"block={self.block}")
            self.range_.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.log is None:
            self.totals[self.name] = (self.totals.get(self.name, 0.0)
                                      + (t1 - self.t0) * 1e-9)
        else:
            self.totals[self.name] = self.log.add(
                self.name, self.block, self.t0, t1) * 1e-9
        if self.range_ is not None:
            self.range_.__exit__(None, None, None)
            self.range_ = None


@contextlib.contextmanager
def stage_marks(mark):
    """While open, :func:`stage_mark` on this thread calls ``mark()``
    (the innermost ``stage_marks`` wins)."""
    outer = getattr(_stage, "mark", None)
    _stage.mark = mark
    try:
        yield
    finally:
        _stage.mark = outer


def stage_mark():
    """The landmark stage of the work in progress has been enqueued: tell
    the open :func:`stage_marks` on this thread, if any."""
    mark = getattr(_stage, "mark", None)
    if mark is not None:
        mark()


def record_run(record):
    """Keep ``record`` (a finished run's) among :func:`recent_runs`."""
    with _recent_lock:
        _recent.append(record)


def recent_runs():
    """The run records of the last ``RECENT_RUNS`` finished passes of
    ``StreamingLandmarkAnalysis.run`` in this process, newest last (the
    engine keeps its own last one as ``run_trace_``).  A record is a dict:

    - ``phases``: the phase names; ``spans``: arrays ``phase`` (an index
      into ``phases``), ``block``, ``start_ns``, ``end_ns``, one entry a
      span, stamps on the profiler's clock (Unix-epoch nanoseconds;
      ``clock_offset_ns`` maps ``time.perf_counter_ns()`` onto it).  The
      loop's phases (``phase_times_``'s keys) are disjoint spans of the
      engine's thread, ``read`` spans (``reader[lo:hi]``) run on the
      feeder's thread; ``block`` is the first frame of the block a span
      served, -1 for none (set-up, the accumulators' copies, finalize,
      the feeder's last wait);
    - ``blocks``: the block ids of the run, in order;
    - ``device``: None on a CPU device, else per block (``block``) the
      card's milliseconds from the start of its assignment to its end
      (``assign_ms``) and from there to the end of its fold (``fold_ms``),
      CUDA events on the compute stream; with the kernel routes (K1, K3)
      on one device also from the start of its assignment to the end of
      its landmark stage (``lv_ms``: ``lv_tile`` on K1's whole-row route,
      ``lv_tile`` and ``row_prep`` with the clip or f32 operands,
      ``lv_gather`` on K3, before the similarity product);
    - ``gate``: the fused-route gate's decision
      (``ops.landmark_mxu._engine_gate``: ``route``, ``cost_ratio``,
      ``max_cost_ratio``, ``s_tile``, ``UP``, ``n_sites``,
      ``vertex_slots``), whether it took K1 or refused it; None where the
      kernels are off (the dense route asks no gate);
    - ``decode``: the I/O pool's tasks and thread-seconds over the run
      (``tasks``, ``busy_s``) and its size (``threads``);
    - ``fold``: the jump-scan kernel's launches in the run (``launches``,
      ``ops.jumps.jump_fold.launches``; 0 on a CPU device, where the plain
      loop runs) and the jumps the run tallied (``jumps``);
    - ``lv_tile``: K1's landmark kernel's launches in the run by form
      (``ops._cuda.lv_tile.rows_launches``, ``.f32_launches``): ``rows``,
      the whole-row form (bf16 operands, no clip: the bf16 copy and
      ``inv_norm``, no ``row_prep``), ``f32``, the f32 form (K1 with the
      clip or f32 operands, and K2); 0 on a CPU device and on the gather
      route;
    - ``stage``: the run-ahead upload's staging of host blocks into its
      slots (``streaming._Lanes.upload``): the bytes copied as slabs, one
      a run of consecutive columns (``slab_bytes``), the bytes copied by
      ``np.take`` (``take_bytes``), and the host seconds of these copies
      alone (``copy_s``, the wait for a free slot left out); zeros where
      no block went through the slots (``pipeline_depth=0``, blocks
      already on the device);
    - ``frames`` (of the run), ``block_frames``, ``start_ns`` and
      ``wall_s`` (the run's, from set-up to finalize), ``profiled``
      (whether a profiler recorded at the run's start)."""
    with _recent_lock:
        return list(_recent)
