"""CUDA kernels the profiled pass launched, over its frames."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("frames"):
        return None
    n = sum(1 for o in tr["ops"] if o[1] == "kernel")
    return n / ctx["frames"] if n else None
