"""replay_ms.cifar: the median device ms of ``graph.replay``
(``engine/graph.py:GraphedNI.replay``: one micro-batch's whole NI run as
one CUDA graph)."""

from benchmark.harness.spans import median_ms


def read(ctx):
    return median_ms("graph.replay")
