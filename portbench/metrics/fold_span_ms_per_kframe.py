"""The card's milliseconds, per 1000 frames, from the end of each block's
assignment to the end of its fold of the jump statistics and accumulators:
the program's own device brackets (CUDA events on the compute stream,
``run_trace_["device"]["fold_ms"]``), summed over the untraced pass of the
traced run.  A bracket holds the fold's kernels and whatever time the
stream waited for the host to launch them.

The run records are the program's (``sitator_tpu_torch.util.timing.
recent_runs``); the other readers of them find them here."""


def runs():
    """``(untraced, profiled)`` run records of this process: the newest
    profiled one, and the newest unprofiled one before it (the pass the
    traced run makes first); None for either that is not there, or where
    the program keeps no records."""
    try:
        from sitator_tpu_torch.util import timing
    except ImportError:
        return None, None
    recent = getattr(timing, "recent_runs", None)
    if recent is None:
        return None, None
    rs = recent()
    at = [i for i, r in enumerate(rs) if r.get("profiled")]
    if not at:
        return None, None
    before = [r for r in rs[:at[-1]] if not r.get("profiled")]
    return (before[-1] if before else None), rs[at[-1]]


def bracket_ms_per_kframe(key):
    """Sum of the untraced pass's device brackets ``key`` in ms a 1000
    frames, or None without them."""
    run, _ = runs()
    if run is None or not run.get("device") or not run.get("frames"):
        return None
    return float(run["device"][key].sum()) / (run["frames"] / 1000.0)


def read(ctx):
    return bracket_ms_per_kframe("fold_ms")
