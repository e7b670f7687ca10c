"""The card's milliseconds, per 1000 frames, from the start of each block's
assignment to its end (K1 or K3 with their input preparation, the drift
and the label egress): the program's own device brackets (CUDA events on
the compute stream, ``run_trace_["device"]["assign_ms"]``), summed over the
untraced pass of the traced run."""
from portbench.metrics.fold_span_ms_per_kframe import bracket_ms_per_kframe


def read(ctx):
    return bracket_ms_per_kframe("assign_ms")
