"""track.setup_ms_per_signal_s: the host time of the program's
`track.setup` spans (`setup_tracking`: config, code tables, constants,
schedule and their upload) in the traced window, per second of signal."""
UNIT = "ms/signal_s"
END_TO_END = False
SPAN = "track.setup"


def read(ctx):
    if ctx.family != "track" or ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    spans = [(max(a, lo), min(b, hi)) for a, b, name in ctx.trace.host
             if name == SPAN and b > lo and a < hi]
    signal = ctx.extras["signal_s"]
    if not spans or signal <= 0:
        return None
    return 1e3 * sum(b - a for a, b in spans) / signal
