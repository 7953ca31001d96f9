"""The whole request's share of the card's bf16 peak over its device
time: the model's operations of an image with its scene's encode
(``work/model.py``) over the device time of an image
(``render_device_ms``'s reading of the profiled window)."""


def read(ctx):
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    ops = ctx.work('model').render_ops(ctx.cfg)
    return 100.0 * ops * ctx.units / busy / ctx.peak['bf16_flops']
