"""img_per_s: every image the window completed over its whole length (host
clock); the window ends with the request in flight at --seconds."""


def read(ctx):
    return ctx.images / ctx.window_s if ctx.window_s > 0 else None
