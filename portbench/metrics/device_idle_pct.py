"""Share (%) of the profiled pass's wall time in which no operation
(kernel, copy or set) ran on the card: 1 − the union of their intervals
over the window."""


def read(ctx):
    s = ctx.get("summary")
    if not s or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
