"""decode_ms.sd3: the median device ms of ``vae.decode``
(``models/vae.py:AutoencoderKL.decode``, one request's images)."""

from benchmark.harness.spans import median_ms


def read(ctx):
    return median_ms("vae.decode")
