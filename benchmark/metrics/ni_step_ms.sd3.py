"""ni_step_ms.sd3: the median device ms of ``ni.step``
(``engine/ni.py:natural_inference``, one step: the CFG forward of the
MMDiT, ``to_x0`` and K1): the card's time from the step's start to its last
work.  The inside counterpart of ``step_ms.sd3``, which also counts the
hoisted adaLN products and a sync."""

from benchmark.harness.spans import median_ms


def read(ctx):
    return median_ms("ni.step")
