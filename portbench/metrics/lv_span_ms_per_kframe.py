"""The card's milliseconds, per 1000 frames, from the start of each block's
assignment to the end of its landmark stage (K1: its input preparation,
``lv_tile`` and ``row_prep``; K3: its input preparation and
``lv_gather``), before the similarity product: the program's own device
brackets (CUDA events on the compute stream,
``run_trace_["device"]["lv_ms"]``), summed over the untraced pass of the
traced run.  None on a program without these brackets."""
from portbench.metrics.fold_span_ms_per_kframe import runs


def read(ctx):
    run, _ = runs()
    if (run is None or not run.get("device") or "lv_ms" not in run["device"]
            or not run.get("frames")):
        return None
    return float(run["device"]["lv_ms"].sum()) / (run["frames"] / 1000.0)
