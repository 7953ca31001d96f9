"""Device ms of the encode an image: the kernels launched inside the
benchmark's ``bench.encode`` spans (``models/renderer.py:encode``, the
``encoders/``), over the traced images."""


def read(ctx):
    s = ctx.trace.launched_within('bench.encode')
    return 1e3 * s / ctx.units if s > 0 else None
