"""track.drain_hidden_share: the share of the tracking driver's blocks
whose drain (the copy of its outputs to the host, their placement and
the derived fields) finished while a later block was still on the
device, so that the host's work hid behind the kernel: the program's
`track.drains_hidden` counter over its `track.blocks`, both since the
process started, warm-up request included.  Only a request's last block
cannot be hidden.  Nothing where the program lacks the counter."""
UNIT = "%"
END_TO_END = False


def read(ctx):
    if ctx.family != "track":
        return None
    try:
        from bds3_tpu_torch.utils.trace import counters
    except ImportError:         # a program without the counters
        return None
    c = counters()
    hidden, blocks = c.get("track.drains_hidden"), c.get("track.blocks")
    if hidden is None or not blocks:
        return None
    return 100.0 * hidden / blocks
