"""Share (%) of a pass's wall time that the engine's host loop spent in
its fold phase (``phase_times_['dispatch_fold']``: enqueuing the
statistics of each block, and waiting on a full launch queue), read in the
untraced pass of the traced run."""


def read(ctx):
    pt, wall = ctx.get("phase_times"), ctx.get("phase_wall_s")
    if not pt or not wall or "dispatch_fold" not in pt:
        return None
    return 100.0 * pt["dispatch_fold"] / wall
