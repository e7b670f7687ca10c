"""Share (%) of the profiled window in which no operation runs on the card
while the engine's host loop is inside a ``dispatch_fold`` span: the
program's spans of the profiled pass (``run_trace_["spans"]``, on the
profiler's clock) intersected with the gaps between the device
operations of the trace."""
from portbench.harness.trace import union_ns
from portbench.metrics.fold_span_ms_per_kframe import runs


def read(ctx):
    _, run = runs()
    tr = ctx.get("trace")
    if (run is None or not tr or not tr["ops"] or tr["window_ns"] is None
            or "dispatch_fold" not in run["phases"]):
        return None
    lo, hi = tr["window_ns"]
    _, gaps = union_ns([(o[2], o[3]) for o in tr["ops"]], lo, hi)
    sp = run["spans"]
    sel = sp["phase"] == run["phases"].index("dispatch_fold")
    folds = sorted(zip(sp["start_ns"][sel].tolist(),
                       sp["end_ns"][sel].tolist()))
    idle, i = 0, 0
    for s, e in gaps:      # both lists sorted and disjoint
        while i < len(folds) and folds[i][1] <= s:
            i += 1
        j = i
        while j < len(folds) and folds[j][0] < e:
            idle += max(0, min(e, folds[j][1]) - max(s, folds[j][0]))
            j += 1
    return 100.0 * idle / (hi - lo)
