"""The engine host loop's milliseconds, per 1000 frames, spent copying each
block's columns into the pinned slots of the upload ring, the wait for a
free slot left out: the program's own counter
(``run_trace_["stage"]["copy_s"]``, ``streaming._Lanes.upload``), read in
the untraced pass of the traced run.  None on a program without the
counter, and on a CPU device, where no block goes up to a card (the run
record's ``device`` is None)."""
from portbench.metrics.fold_span_ms_per_kframe import runs


def read(ctx):
    run, _ = runs()
    if (run is None or not run.get("stage") or run.get("device") is None
            or not run.get("frames")):
        return None
    return 1e3 * float(run["stage"]["copy_s"]) / (run["frames"] / 1000.0)
