"""The device's idle ms a step while the host was inside the loss
(``car.train.forward``: the model's forward and the loss, with the
model's spans within it), over the traced steps."""

from harness import spans


def read(ctx):
    u = spans.union(ctx.trace, ('car.train.forward',))
    if not u or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * spans.idle_inside(ctx.trace, u) / ctx.units
