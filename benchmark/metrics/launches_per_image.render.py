"""Kernel launches a rendered image (the traced window's device kernels
over its images): the host's address math and block loop
(``train/evaluation.py``, ``models/renderer.py:forward``) launch most of
them."""


def read(ctx):
    n = len(ctx.trace.kernels())
    return n / ctx.units if n else None
