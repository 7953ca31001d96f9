"""The card's peak allocated memory over the run (the train state, Adam's
moments and the step's activations), in GB."""


def read(ctx):
    m = ctx.memory_peak_bytes
    return m / 1e9 if m > 0 else None
