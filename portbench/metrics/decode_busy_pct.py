"""Share (%) of the trajectory reader's decode capacity in use over the
untraced pass: the thread-seconds of the I/O pool's tasks (chunks read and
decoded, ``run_trace_["decode"]``) over the pass's wall times the pool's
threads."""
from portbench.metrics.fold_span_ms_per_kframe import runs


def read(ctx):
    run, _ = runs()
    if run is None or not run.get("decode") or not run.get("wall_s"):
        return None
    d = run["decode"]
    if not d["tasks"]:
        return None
    return 100.0 * d["busy_s"] / (run["wall_s"] * d["threads"])
