"""track.nonk1_ms_per_signal_s: the requests' wall time less K1's device
time, per second of signal: what the program's tracking driver
(`track.driver`) adds around K1 (set-up, other launches, the download,
the assembly of the results)."""
UNIT = "ms/signal_s"
END_TO_END = False
KERNEL = "track_fused_kernel"


def read(ctx):
    if ctx.family != "track" or ctx.trace is None:
        return None
    signal = ctx.extras["signal_s"]
    if signal <= 0:
        return None
    return 1e3 * (ctx.extras["request_wall_s"]
                  - ctx.trace.device_s(KERNEL)) / signal
