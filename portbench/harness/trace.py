"""One pass under ``torch.profiler``, read into device operations
attributed to the layer and the engine phase that launched them.

Spans come from the benchmark's side only: while a pass is traced, each
function that ``spans/<name>.json`` lists is wrapped in a
``record_function`` named ``pb.span.<name>`` (the layer's entry points:
the assignment kernels' wrappers, the fold of the statistics), and the
engine's phase timer ``streaming._Phase`` opens ``pb.phase.<phase>`` beside
its clock.  A device operation belongs to the span and phase whose range,
on the launching thread, holds the time of its launch (the CUDA runtime
call that CUPTI correlates with it, else the operator it ran under), so a
renamed kernel still counts where it was launched from.  The port's own
CUDA kernels are launched through ``ctypes`` from a library of its own,
and the profiler records neither a runtime call nor an operator for them:
such an operation takes the span and phase of the operation before it on
the same stream, which the same wrapper launched (each wrapper prepares
its inputs with PyTorch operations before its first kernel).  Everything
is restored when the pass ends."""
import bisect
import importlib
import time
from collections import defaultdict

import torch

SPAN, PHASE, WINDOW = "pb.span.", "pb.phase.", "pb.window"
NAME_CHARS = 120        # of a kernel's name in the breakdown


class _Patched:
    """Wrap the span functions and the phase timer while the context is
    open."""

    def __init__(self, spans):
        self.spans = spans
        self.saved = []

    def __enter__(self):
        from torch.autograd.profiler import record_function
        for span, targets in self.spans.items():
            for mod_name, fn_name in targets:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, fn_name)
                inner = _wrapped(fn, SPAN + span, record_function)
                self.saved.append((mod, fn_name, fn, inner))
                setattr(mod, fn_name, inner)
        streaming = importlib.import_module(
            "sitator_tpu_torch.landmark.streaming")
        base = streaming._Phase

        class Phase(base):
            __slots__ = ("rf",)

            def __enter__(self):
                self.rf = record_function(PHASE + self.name)
                self.rf.__enter__()
                return base.__enter__(self)

            def __exit__(self, *exc):
                base.__exit__(self, *exc)
                self.rf.__exit__(None, None, None)

        self.saved.append((streaming, "_Phase", base, None))
        streaming._Phase = Phase
        return self

    def __exit__(self, *exc):
        for mod, name, fn, inner in reversed(self.saved):
            setattr(mod, name, fn)
            if inner is not None:   # counters counted on the wrapper
                fn.__dict__.update({k: v for k, v in inner.__dict__.items()
                                    if k != "__wrapped__"})
        self.saved.clear()


def _wrapped(fn, label, record_function):
    def inner(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    inner.__wrapped__ = fn
    inner.__name__ = getattr(fn, "__name__", label)
    # the program counts launches in attributes of the function it calls
    inner.__dict__.update(getattr(fn, "__dict__", {}))
    return inner


def capture(fn, spans, cuda):
    """``(fn(), wall seconds, trace)`` with ``fn`` run once under the
    profiler (CPU, and CUDA when ``cuda``) with the spans in place."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _Patched(spans), profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = extract(prof.profiler.kineto_results.events())
    trace["extract_s"] = time.perf_counter() - t0
    return out, wall, trace


def _activity(e):
    get = getattr(e, "activity_type", None)
    try:
        return str(get()) if get else ""
    except (RuntimeError, TypeError):
        return ""


class _Ranges:
    """Disjoint ``[start, end)`` ranges with names, one sorted list a
    thread; :meth:`at` names the range holding a time."""

    def __init__(self):
        self.by_tid = defaultdict(list)

    def add(self, tid, start, end, name):
        self.by_tid[tid].append((start, end, name))

    def seal(self):
        self.starts = {}
        for tid, rows in self.by_tid.items():
            rows.sort()
            self.starts[tid] = [r[0] for r in rows]

    def at(self, tid, t):
        rows = self.by_tid.get(tid)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        if i >= 0 and rows[i][0] <= t < rows[i][1]:
            return rows[i][2]
        return None


def _stream(e):
    get = getattr(e, "device_resource_id", None)
    return get() if get else 0


def extract(events):
    """The device operations of a trace, each ``(name, kind, start_ns,
    end_ns, span, phase)``, and the window: ``{"ops", "window_ns",
    "unlaunched", "phases"}`` (``unlaunched`` counts the operations whose
    launch was not found, attributed after the one before them on their
    stream)."""
    spans, phases = _Ranges(), _Ranges()
    runtime, frontend = {}, {}
    window = None
    dev = []
    for e in events:
        act = _activity(e)
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if act in ("cuda_runtime", "cuda_driver") or (
                    not act and e.linked_correlation_id() > 0):
                runtime[e.correlation_id()] = (e.start_ns(),
                                               e.start_thread_id())
                continue
            if e.linked_correlation_id() == 0:
                frontend[e.correlation_id()] = (e.start_ns(),
                                                e.start_thread_id())
            if name.startswith(SPAN):
                spans.add(e.start_thread_id(), e.start_ns(), e.end_ns(),
                          name[len(SPAN):])
            elif name.startswith(PHASE):
                phases.add(e.start_thread_id(), e.start_ns(), e.end_ns(),
                           name[len(PHASE):])
            elif name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            continue
        if "user_annotation" in act or e.is_user_annotation():
            continue
        if act == "gpu_memcpy" or name.startswith("Memcpy"):
            kind = "memcpy"
        elif act == "gpu_memset" or name.startswith("Memset"):
            kind = "memset"
        else:
            kind = "kernel"
        dev.append((e.start_ns(), e.end_ns(), name, kind, e.correlation_id(),
                    e.linked_correlation_id(), _stream(e)))
    spans.seal()
    phases.seal()
    dev.sort()
    ops, unlaunched, before = [], 0, {}
    for start, end, name, kind, corr, linked, stream in dev:
        launch = runtime.get(corr) or frontend.get(linked)
        if launch is None:
            unlaunched += 1
            where = before.get(stream, (None, None))
        else:
            t, tid = launch
            where = before[stream] = (spans.at(tid, t), phases.at(tid, t))
        ops.append((name, kind, start, end) + where)
    return dict(ops=ops, window_ns=window, unlaunched=unlaunched,
                phases=phases)


def union_ns(intervals, lo, hi):
    """Total length of the union of ``intervals`` clipped to ``[lo, hi)``,
    and the gaps between them there, as ``(busy, [(start, end), ...])``."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def summary(trace):
    """Busy and window seconds, and the breakdown the result line carries:
    the ten device operations of most time, and the idle time by the
    engine phase the host was in when each gap began."""
    ops = trace["ops"]
    win = trace["window_ns"]
    if not ops or win is None:
        return None
    lo, hi = win
    busy, gaps = union_ns([(o[2], o[3]) for o in ops], lo, hi)
    by_name = defaultdict(float)
    for o in ops:
        by_name[o[0][:NAME_CHARS]] += (o[3] - o[2]) * 1e-9
    phases = trace["phases"]
    idle = defaultdict(float)
    for s, e in gaps:
        where = next((p for p in (phases.at(t, s) for t in phases.by_tid)
                      if p), "outside the engine's phases")
        idle[where] += (e - s) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy * 1e-9, window_s=(hi - lo) * 1e-9,
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in gaps_top])
