"""The device's idle ms a step while the host was inside the optimizer
(``car.train.clip``: the global norm and the scaling; ``car.train.adam``:
the Adam update), over the traced steps."""

from harness import spans


def read(ctx):
    u = spans.union(ctx.trace, ('car.train.clip', 'car.train.adam'))
    if not u or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * spans.idle_inside(ctx.trace, u) / ctx.units
