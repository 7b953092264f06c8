"""track.d2h_MB_per_signal_s: the bytes the program's tracking driver
copied from the device to the host (its `track.d2h_bytes` counter) over
the seconds of signal its requests returned (`track.signal_ms`), both
since the process started, warm-up request included, so their ratio is
exact."""
UNIT = "MB/signal_s"
END_TO_END = False


def read(ctx):
    if ctx.family != "track":
        return None
    try:
        from bds3_tpu_torch.utils.trace import counters
    except ImportError:         # a program without the counters
        return None
    c = counters()
    d2h, signal_ms = c.get("track.d2h_bytes"), c.get("track.signal_ms")
    if not d2h or not signal_ms:
        return None
    return (d2h / 1e6) / (signal_ms / 1e3)
