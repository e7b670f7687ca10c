"""Share (%) of a pass's wall time that the engine's loop waited for the
next block from the feeder thread (``phase_times_['feeder']``): the
trajectory reader and its decoding threads not keeping up.  Read in the
untraced pass of the traced run."""


def read(ctx):
    pt, wall = ctx.get("phase_times"), ctx.get("phase_wall_s")
    if not pt or not wall or "feeder" not in pt:
        return None
    return 100.0 * pt["feeder"] / wall
