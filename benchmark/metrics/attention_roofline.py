"""attention_roofline: the least time of the traced requests' joint
attentions (operations-bound) over the device time of kernel K9
(``csrc/attention.cu``), per cent."""

from benchmark.harness.readers import roofline_pct

FAMILIES = ("flash_ring_kernel", "flash_split_kernel")


def read(ctx):
    return roofline_pct(ctx, FAMILIES, ctx.counts.attention_least_s)
