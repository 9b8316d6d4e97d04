"""Micro-bench: the attention kernels against the einsum pair at MMDiT's
joint lengths (port of ``naturaldiffusion_tpu/apps/bench_attention.py``).

SD3-medium runs joint attention over 4096 latent tokens and its text
context (``src/SD3NaturalInference.py:210-213``): 4250 = 4096 + 154 with
the CLIP context, 4429 with the T5 variant.  Neither is a multiple of a
tile, so the kernels' masking of keys past T is on the path.  Per length it
times ``mha`` with the backends ``"xla"`` (the einsum pair in bf16),
``"flash"`` (kernel K9) and ``"splash"`` (kernel K10, pre-scaled q).

    python -m naturaldiffusion_tpu_torch.apps.bench_attention [--device cuda]

Prints one JSON line per length with ms per call (the median of 3 timed
chains of 20 calls, CUDA events) and TFLOP/s from
``4 * b * h * t^2 * d``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops.attention import mha
from ..utils.profiling import Timer

BACKENDS = ("xla", "flash", "splash")


def bench(t: int, b: int = 2, h: int = 24, d: int = 64, reps: int = 20,
          device="cuda"):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    timer = Timer(iters=3, device=dev)
    out = {}
    for backend in BACKENDS:
        def chain(backend=backend):
            for _ in range(reps):
                mha(q, k, v, backend=backend)
        out[backend] = timer(chain) / reps
        if not torch.isfinite(mha(q, k, v, backend=backend)).all():
            raise FloatingPointError(f"{backend}: non-finite output")
    flops = 4 * b * h * t * t * d
    row = {"t": t, "b": b, "h": h, "d": d,
           "xla_ms": out["xla"] * 1e3,
           "flash_ms": out["flash"] * 1e3,
           "splash_ms": out["splash"] * 1e3,
           "speedup": out["xla"] / out["flash"],
           "flash_tflops": flops / out["flash"] / 1e12,
           "splash_tflops": flops / out["splash"] / 1e12,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 4250 = 4096 + 154 (SD3 CLIP77+77 context); 4429 = +T5-333 variant
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[4096, 4250, 4429])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for t in args.lengths:
        bench(t, b=args.batch, h=args.heads, device=args.device)
    return 0


if __name__ == "__main__":
    main()
