"""Device ms an image: the time in which an operation ran on the card
(the union of its kernels, copies and fills) over the images of the
profiled window that follows the timed one. The card's own share of a
request, which the host's speed does not move."""


def read(ctx):
    busy = ctx.trace.busy_s
    return 1e3 * busy / ctx.units if busy > 0 else None
