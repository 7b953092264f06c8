"""track_rt: seconds of signal tracked (all channels of a request) per
second of the window, over every request of the window."""
UNIT = "signal_s/s"
END_TO_END = True


def read(ctx):
    if ctx.family != "track":
        return None
    return ctx.window.rate()
