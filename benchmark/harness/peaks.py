"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W power limit): the yardstick of ``mfu.*`` and
of every ``*_roofline`` share."""

BF16_FLOPS = 989e12         # tensor cores, bfloat16 and float16
HBM_BYTES = 3.35e12         # HBM3, bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
