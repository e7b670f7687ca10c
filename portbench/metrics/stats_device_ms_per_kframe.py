"""Device milliseconds, per 1000 frames, of the kernels launched by the
fold of the jump statistics and accumulators (the span around
``landmark/streaming.py::_accum_block``, which calls ``ops/jumps.py``) in
the profiled pass."""
from portbench.metrics import span_seconds


def read(ctx):
    got = span_seconds(ctx, "stats")
    if not got or not got[1]:
        return None
    return got[0] * 1e3 / (ctx["frames"] / 1000.0)
