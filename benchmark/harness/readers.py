"""What several metric readers share.  Each returns None where its run
has nothing to read (no traced stretch, no kernel of the family in it)."""

from __future__ import annotations

import statistics

from . import peaks


def idle_share_pct(ctx):
    """Per cent of the traced window in which no device operation ran."""
    p = ctx.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def mfu_pct(ctx):
    """The window's FLOPs (from the shapes) over its seconds, per cent of
    the card's bf16 peak."""
    if not ctx.requests or ctx.window_s <= 0:
        return None
    flops = ctx.counts.request_flops(ctx.spec, ctx.traffic) * ctx.requests
    return 100.0 * flops / ctx.window_s / peaks.BF16_FLOPS


def roofline_pct(ctx, families, least_s):
    """Per cent: ``least_s(spec, traffic, least)`` (one request's least
    seconds for these kernels) times the traced requests, over the device
    seconds of ``families`` in the traced window."""
    p = ctx.profile
    if p is None:
        return None
    busy = p.family_s(families)
    if busy <= 0:
        return None
    least = least_s(ctx.spec, ctx.traffic, peaks.least_seconds)
    return 100.0 * least * p.requests / busy


def span_ms(ctx, name, per=1):
    """Mean host milliseconds of the window's ``name`` spans, over
    ``per``."""
    v = ctx.spans.get(name)
    return statistics.fmean(v) * 1e3 / per if v else None
