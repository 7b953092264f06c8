"""setup_s: process start to the first timed request, every cell."""
UNIT = "s"
END_TO_END = True


def read(ctx):
    return ctx.setup_s
