"""Kernel launches an image made while the host was inside the ray math:
the union of the program's ``car.geometry`` spans (the ray and segment
geometry, the per-sample query features and the attention-derived depth
of ``models/renderer.py:forward``) and ``car.address_math`` (the stream
takes, ``_stream_takes``), over the traced images. A part of
``launches_per_image``."""

from harness import spans


def read(ctx):
    n = len(spans.launched_inside(ctx.trace,
                                  spans.union(ctx.trace, spans.RAY_MATH)))
    return n / ctx.units if n else None
