"""``render_images_per_s`` of the timed window (host clock), in the cells
where the host's speed spreads it too widely for an end-to-end bound."""


def read(ctx):
    return ctx.host.get('render_images_per_s', (None,))[0]
