"""group_norm_roofline: the least time of the traced requests' standalone
GroupNorms (bytes-bound) over the device time of kernel K6
(``csrc/group_norm.cu``, every form), per cent."""

from benchmark.harness.readers import roofline_pct

FAMILIES = ("gn_onchip_kernel", "gn_grid_kernel", "gn_stats_kernel",
            "gn_apply_kernel")


def read(ctx):
    return roofline_pct(ctx, FAMILIES, ctx.counts.group_norm_least_s)
