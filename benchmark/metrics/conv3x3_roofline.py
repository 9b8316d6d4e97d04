"""conv3x3_roofline: the least time of the traced requests' 3x3 convs (each
the larger of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s)
over the device time of the port's conv kernels (``csrc/conv3x3.cu``: K2,
K3 and K4), per cent."""

from benchmark.harness.readers import roofline_pct

FAMILIES = ("conv3x3_tc_kernel", "conv3x3_kernel", "conv3x3_tiled_kernel")


def read(ctx):
    return roofline_pct(ctx, FAMILIES, ctx.counts.conv3x3_least_s)
