"""step_ms.sd3: mean host milliseconds of the window's
``SD3Pipeline.__call__`` (the NI loop: CFG forwards of the MMDiT and K1's
sums, without the decode), synchronised, over its steps."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "sample", per=ctx.spec["steps"])
