"""The device's idle ms a step while the host was inside the backward
pass (``car.train.backward``, ``tot.backward()``; autograd's thread
launches its kernels while the span is open), over the traced steps."""

from harness import spans


def read(ctx):
    u = spans.union(ctx.trace, ('car.train.backward',))
    if not u or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * spans.idle_inside(ctx.trace, u) / ctx.units
