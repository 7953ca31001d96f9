"""Device ms an image of the kernels launched inside the ray math
(``ray_math_launches``' kernels: the geometry's and the address math's
small elementwise kernels and ``cat`` copies), over the traced images."""

from harness import spans


def read(ctx):
    s = sum(d[2] for d in spans.launched_inside(
        ctx.trace, spans.union(ctx.trace, spans.RAY_MATH)))
    return 1e3 * s / ctx.units if s > 0 else None
