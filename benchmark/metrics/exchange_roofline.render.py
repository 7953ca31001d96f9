"""The exchange's share of its roofline: the least time its work
(``work/exchange.py``, from the configuration's shapes) takes at the
card's published peaks, over the device time of the kernels mapped to
it."""


def read(ctx):
    w = ctx.work('exchange')
    secs = ctx.trace.kernel_seconds(w.KERNELS)
    if secs <= 0:
        return None
    ops, nbytes = w.work(ctx.cfg, ctx.units)
    bound = max(ops / ctx.peak['bf16_flops'],
                nbytes / ctx.peak['hbm_bytes_per_s'])
    return 100.0 * bound / secs
