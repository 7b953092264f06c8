"""k1.sm_share: a readout of K1's (`track_fused_kernel`) launch geometry,
not a measurement of SM use on the device: the blocks the program's
wrapper launched (its `k1.blocks` counter) over its launches
(`k1.launches`), both since the process started, warm-up request included
(a cell's launches all have one shape), over the card's multiprocessor
count.  K1 runs one block an SM, so this is the share of the SMs that
hold a block of each launch, and it means that only while all of a
launch's blocks are resident at once, as they are wherever the wrapper
gives a channel two blocks or more.  With more channels than SMs (one
block a channel, in waves) it reads above 100%, and says only that."""
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
    blocks, launches = c.get("k1.blocks"), c.get("k1.launches")
    if not blocks or not launches:
        return None
    import torch

    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return 100.0 * blocks / launches / props.multi_processor_count
