"""Both attention rounds' share of their roofline (``work/attention.py``;
bound by bytes), over the device time of the kernels mapped to them."""


def read(ctx):
    w = ctx.work('attention')
    secs = ctx.trace.kernel_seconds(w.KERNELS)
    if secs <= 0:
        return None
    ops, nbytes = w.work(ctx.cfg, ctx.units)
    bound = max(ops / ctx.peak['f32_flops'],
                nbytes / ctx.peak['hbm_bytes_per_s'])
    return 100.0 * bound / secs
