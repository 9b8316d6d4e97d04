"""s_per_image: the window's whole length over the images it completed
(host clock).  At one image a request this is the latency a user waits."""


def read(ctx):
    return ctx.window_s / ctx.images if ctx.images else None
