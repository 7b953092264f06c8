"""track.download_ms_per_signal_s: the time of the program's
`track.download` spans (the copy of each request's output rows to the
host) in the traced window, less the tracking kernel's device time inside
them (the copy waits there for the launches queued before it), per second
of signal."""
UNIT = "ms/signal_s"
END_TO_END = False
SPAN = "track.download"
KERNEL = "track_fused_kernel"


def read(ctx):
    if ctx.family != "track" or ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    spans = [(max(a, lo), min(b, hi)) for a, b, name in ctx.trace.host
             if name == SPAN and b > lo and a < hi]
    signal = ctx.extras["signal_s"]
    if not spans or signal <= 0:
        return None
    k1 = [(x, y) for x, y, name in ctx.trace.device if KERNEL in name]
    return 1e3 * sum((b - a) - sum(max(0.0, min(b, y) - max(a, x))
                                   for x, y in k1 if y > a and x < b)
                     for a, b in spans) / signal
