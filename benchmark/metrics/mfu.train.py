"""The whole step's share of the card's bf16 peak: the model's forward
and backward operations of a step (``work/model.py``) times the steps a
second of the untraced window (host clock: the window of the run's
end-to-end metrics; the profiler slows the host, so its window is not
used)."""


def read(ctx):
    if ctx.rate <= 0:
        return None
    ops = ctx.work('model').train_ops(ctx.cfg, ctx.traffic)
    return 100.0 * ops * ctx.rate / ctx.peak['bf16_flops']
