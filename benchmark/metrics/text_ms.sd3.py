"""text_ms.sd3: the median device ms of ``sd3.encode_prompt``
(``pipeline.py:SD3Pipeline.encode_prompt``: CLIP-L, CLIP-G and T5-XXL for
one prompt).  The inside counterpart of ``encode_ms.sd3``, which times two
prompts."""

from benchmark.harness.spans import median_ms


def read(ctx):
    return median_ms("sd3.encode_prompt")
