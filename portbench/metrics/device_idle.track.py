"""device_idle.track: the share of the traced window in which nothing ran
on the device, in the tracking cells."""
UNIT = "%"
END_TO_END = False


def read(ctx):
    if ctx.family != "track" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
