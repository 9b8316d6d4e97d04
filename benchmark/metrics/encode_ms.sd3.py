"""encode_ms.sd3: mean host milliseconds of the window's two
``encode_prompt`` calls a request (prompt and negative), synchronised
before and after: CLIP-L, CLIP-G and T5-XXL."""

from benchmark.harness.readers import span_ms


def read(ctx):
    return span_ms(ctx, "encode")
