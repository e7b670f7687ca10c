"""Stage timing + profiling hooks (counterpart of
``sitator_tpu.util.timing``).

A structured per-stage timing report, and optional ``torch.profiler`` trace
capture around any stage (the reference captures ``jax.profiler`` traces).
The trace records the host's operators and, when a CUDA device is present,
the card's kernels and copies; it is written under ``trace_dir`` as a
Chrome trace (``*.pt.trace.json``), which TensorBoard's profiler plugin and
Perfetto read.
"""
from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger(__name__)


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
    (host operators, plus the card's activity when CUDA is available).
    The card's work is synchronised before the trace closes, so its last
    kernels are in it."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
        if cuda:
            torch.cuda.synchronize()
