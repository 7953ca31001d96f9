"""The device's idle ms an image while the host was inside the ray math
(the union of ``car.geometry`` and ``car.address_math``: leaves, so their
idle is their own), over the traced images."""

from harness import spans


def read(ctx):
    u = spans.union(ctx.trace, spans.RAY_MATH)
    if not u or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * spans.idle_inside(ctx.trace, u) / ctx.units
