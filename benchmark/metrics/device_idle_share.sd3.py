"""Per cent of the traced requests' span in which no kernel, copy or set
ran on the card (the union of the device intervals, from the trace)."""

from benchmark.harness.readers import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx)
