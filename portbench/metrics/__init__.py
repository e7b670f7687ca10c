"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``.  Each module's ``read(ctx)`` returns the
metric's value, or None where the run holds nothing to read it from; the
harness then leaves the metric out of the line.

``ctx`` holds: ``cfg`` (the configuration), ``frames`` (frames of the
profiled pass), ``phase_times`` and ``phase_wall_s`` (the engine's host
phase clocks and the wall of the untraced pass before the profiled one),
``trace`` (:func:`portbench.harness.trace.extract` of the profiled pass:
device operations with the span and phase that launched them),
``summary`` (:func:`portbench.harness.trace.summary`), ``peaks`` (the
card's published peaks, or None) and ``device_name``."""


def span_seconds(ctx, span):
    """Device seconds and count of the kernels launched inside the span
    ``span`` of the profiled pass, or None without a trace."""
    tr = ctx.get("trace")
    if not tr or not tr["ops"]:
        return None
    sel = [o for o in tr["ops"] if o[1] == "kernel" and o[4] == span]
    return sum(o[3] - o[2] for o in sel) * 1e-9, len(sel)
