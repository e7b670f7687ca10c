"""How far the slowest block of the untraced pass lags the typical one:
a block's period runs from the start of the engine's wait for it (its
``feeder`` span) to the start of the next wait; 100 × (largest / median
− 1) over every block but the first and the last.  Read from the
program's spans (``run_trace_["spans"]``)."""
import numpy as np

from portbench.metrics.fold_span_ms_per_kframe import runs


def read(ctx):
    run, _ = runs()
    if run is None or "feeder" not in run["phases"]:
        return None
    sp = run["spans"]
    waits = np.sort(sp["start_ns"][sp["phase"]
                                   == run["phases"].index("feeder")])
    periods = np.diff(waits)[1:-1]
    if len(periods) < 1:
        return None
    return 100.0 * (float(periods.max()) / float(np.median(periods)) - 1.0)
