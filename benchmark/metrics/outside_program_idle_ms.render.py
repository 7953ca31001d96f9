"""The device's idle ms a unit (image or step) while no span of the
program (``car.*``) was open on any thread: the benchmark's own loop, its
inputs and checks, and the calls into the program before its first span
opens. Over the traced units; nothing where the program records no
span."""

from harness import spans


def read(ctx):
    names = spans.program_names(ctx.trace)
    if not names or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * spans.idle_outside(
        ctx.trace, spans.union(ctx.trace, names)) / ctx.units
