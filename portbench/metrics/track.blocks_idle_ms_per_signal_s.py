"""track.blocks_idle_ms_per_signal_s: the time in which the device ran
nothing while the host was inside the program's `track.blocks` span (the
launch loop), per second of signal: the launch latency and the gaps
between the tracking kernel's blocks."""
UNIT = "ms/signal_s"
END_TO_END = False
SPAN = "track.blocks"


def read(ctx):
    if ctx.family != "track" or ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    spans = [(max(a, lo), min(b, hi)) for a, b, name in ctx.trace.host
             if name == SPAN and b > lo and a < hi]
    signal = ctx.extras["signal_s"]
    if not spans or signal <= 0:
        return None
    busy = ctx.trace.busy()
    idle = sum((b - a) - sum(max(0.0, min(b, y) - max(a, x))
                             for x, y in busy if y > a and x < b)
               for a, b in spans)
    return 1e3 * idle / signal
