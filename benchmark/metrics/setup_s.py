"""setup_s: process start to the first timed request (host clock): the
imports, the kernels' build where the checkout has none, the weights made
from the seed, the graphs captured, one warm request at the cell's shapes."""


def read(ctx):
    return ctx.setup_s
