"""k1_roofline: K1's bound over the window's requests (counts/k1.py, from
the epoch lengths they ran) as a share of K1's device time in the trace."""
UNIT = "%"
END_TO_END = False
KERNEL = "track_fused_kernel"   # csrc/track_fused.cu's kernel


def read(ctx):
    bound = ctx.extras.get("k1_bound_s")
    if ctx.trace is None or not bound:
        return None
    k1 = ctx.trace.device_s(KERNEL)
    return 100.0 * bound / k1 if k1 > 0 else None
