"""Share (%) of the card's roofline that the assignment kernels reach: the
least time the configuration's assignment work could take at the card's
published peaks (``harness/roofline.py``, from the sizes alone) over the
device time of the kernels launched inside the assignment wrappers
(``mxu_assign_blocks`` for K1, ``fused_assign_blocks`` for K3: input prep
and the CUDA kernels) in the profiled pass."""
from portbench.harness.roofline import assign_bound
from portbench.metrics import span_seconds


def read(ctx):
    got = span_seconds(ctx, "assign")
    if not got or not got[1] or not ctx.get("peaks"):
        return None
    bound, _, _ = assign_bound(ctx["cfg"], ctx["frames"], ctx["peaks"])
    return 100.0 * bound / got[0]
