"""Model FLOPs of the window's requests (counted from the shapes by
``benchmark/counts``) over the window's seconds, per cent of the card's
989 TFLOP/s bf16 peak."""

from benchmark.harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
