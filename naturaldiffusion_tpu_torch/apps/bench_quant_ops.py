"""Micro-bench: the W8A8 int8 convs (``ops/quant.py``) against the bf16
conv at the hot shapes of the CIFAR-10 NCSN++ forward (port of
``naturaldiffusion_tpu/apps/bench_quant_ops.py``).

Rows of each 3x3 shape (``SHAPES``), with the JAX app's names:

  * ``bf16``      the control: ``F.conv2d`` (cuDNN, channels-last, bf16);
  * ``int8_dyn``  the whole W8A8 op, the hand-written Q1 kernel: dynamic
                  per-sample activation scales, the weight quantized per
                  call, s8 x s8 -> s32, f32 dequant and bias;
  * ``int8_pt``   the same with one scale per tensor;
  * ``int8_st``   the same with the static clip ``act_amax=6.0``;
  * ``int8_raw``  the product alone: Q1's launch on operands quantized and
                  packed beforehand (the activations already on the int8
                  grid, held exactly in bf16, with the static scale 1; the
                  weight packed with unit scales; no bias), so no scale
                  reduction and no weight quantization runs.

Rows of each 1x1 / NIN shape (``NIN_SHAPES``): ``bf16`` (``torch.matmul``
and the bias), ``int8_dyn`` and ``int8_st`` (``conv1x1_int8``, on
``torch._int_mm``).  One square GEMM (``GEMM_N``): ``bf16``
(``torch.matmul``) against ``int8_raw`` (``torch._int_mm``), the library
yardsticks of the card's int8 : bf16 rate, as the JAX app's are XLA's.

Each row is timed by CUDA events around ``reps`` calls (the median of
``runs``, the rows interleaved: the card drifts); a CPU tensor takes the
plain versions and the host clock.

    python -m naturaldiffusion_tpu_torch.apps.bench_quant_ops \
        [--reps 50] [--runs 7] [--gemm-only | --skip-gemm] [--device cuda]

Prints one JSON line a shape with the JAX app's keys: ``<row>_ms``,
``<row>_tflops``, ``<row>_speedup`` (bf16's time over the row's) and
``<row>_error`` where a row raised.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import quant as Q
from ..utils.profiling import Timer

SHAPES = [
    (64, 32, 32, 128, 128),   # res-32 resblock convs
    (64, 32, 32, 256, 128),   # res-32 up path (skip-concat input)
    (64, 16, 16, 256, 256),   # res-16 resblock convs
    (64, 16, 16, 512, 256),   # res-16 up path
    (64, 8, 8, 256, 256),     # res-8 resblock convs
    (64, 4, 4, 256, 256),     # res-4 resblock convs
]
NIN_SHAPES = [
    (64, 32, 32, 128, 128),   # attention NINs / res-32 shortcut
    (64, 16, 16, 256, 256),   # res-16 attention NINs
    (64, 32, 32, 256, 128),   # up-path 1x1 shortcut (concat input)
]
GEMM_N = 4096
# the static clip of ``int8_st``; ``int8_raw``'s clip 127 makes its scale
# exactly 1, so the kernel's quantize of on-grid activations is exact
ACT_AMAX, RAW_AMAX = 6.0, 127.0


def inputs(shape, device, *, nin=False, seed=0):
    """bf16 ``x [B,H,W,Cin]``, a kernel (``[3,3,Cin,Cout]``, or ``[Cin,
    Cout]`` for a NIN) of scale 0.05 and a zero bias, from ``seed``."""
    bsz, hh, ww, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((bsz, hh, ww, cin), generator=gen, device=device)
    wshape = (cin, cout) if nin else (3, 3, cin, cout)
    w = torch.randn(wshape, generator=gen, device=device) * 0.05
    bias = torch.zeros((cout,), device=device)
    return (x.to(torch.bfloat16), w.to(torch.bfloat16),
            bias.to(torch.bfloat16))


def conv_rows(x, w, bias) -> dict:
    """The 3x3 rows: name -> a call returning the row's NHWC output.  The
    operands of ``int8_raw`` are quantized and packed here, once."""
    xcl = x.permute(0, 3, 1, 2)                   # NCHW view, channels-last
    wcl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_q = Q.quantize_act(x)[0].to(x.dtype)        # on the grid, exact
    w_i8, _, w_kern = Q.quantize_conv_weight(w)
    ones = torch.ones(w.shape[3], dtype=torch.float32, device=x.device)
    return {
        "bf16": lambda: F.conv2d(xcl, wcl, bias, padding=1).permute(
            0, 2, 3, 1),
        "int8_dyn": lambda: Q.conv3x3_int8(x, w, bias),
        "int8_pt": lambda: Q.conv3x3_int8(x, w, bias, per_sample=False),
        "int8_st": lambda: Q.conv3x3_int8(x, w, bias, act_amax=ACT_AMAX),
        "int8_raw": lambda: Q.conv3x3_int8(x_q, None, w_i8=w_i8, s_w=ones,
                                           w_kern=w_kern,
                                           act_amax=RAW_AMAX),
    }


def nin_rows(x, w, bias) -> dict:
    """The 1x1 / NIN rows: name -> a call returning the row's output."""
    return {
        "bf16": lambda: torch.matmul(x, w) + bias,
        "int8_dyn": lambda: Q.conv1x1_int8(x, w, bias),
        "int8_st": lambda: Q.conv1x1_int8(x, w, bias, act_amax=ACT_AMAX),
    }


def gemm_rows(n, device) -> dict:
    """The square GEMM's rows on bf16 ``a @ b`` and its int8 twin (the
    operands times 20, rounded and clipped to +-127, as the JAX app
    makes them)."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)

    def s8(t):
        return torch.clamp(torch.round(t.float() * 20), -127, 127).to(
            torch.int8)
    a8, b8_t = s8(a), s8(b).t().contiguous()
    return {"bf16": lambda: a @ b,
            "int8_raw": lambda: Q._int_mm(a8, b8_t)}


def time_rows(rows: dict, flops: float, reps: int, runs: int, device,
              out: dict) -> dict:
    """Each row's median seconds a call into ``out`` as the JAX app's
    ``_ms``, ``_tflops``, ``_error`` and ``_speedup`` keys."""
    timer = Timer(iters=1, device=device)

    def chain(fn):
        def run():
            for _ in range(reps):
                fn()
        return run

    fns, errors = {}, {}
    for k, f in rows.items():
        try:
            timer.once(f)                         # warm-up: kernel builds
            fns[k] = chain(f)
        except Exception as e:  # noqa: BLE001  reported as the JAX app does
            errors[k] = f"{type(e).__name__}: {str(e)[:200]}"
    times = {k: [] for k in fns}
    for _ in range(runs):                         # interleave: card drift
        for k, f in fns.items():
            times[k].append(timer.once(f))
    med = {k: statistics.median(v) / reps for k, v in times.items()}
    for k, t in med.items():
        out[f"{k}_ms"] = t * 1e3
        out[f"{k}_tflops"] = flops / t / 1e12
    for k, msg in errors.items():
        out[f"{k}_error"] = msg
    if "bf16" in med:
        for k in med:
            if k != "bf16":
                out[f"{k}_speedup"] = med["bf16"] / med[k]
    return out


def bench_shape(shape, reps=50, runs=7, device="cuda"):
    dev = resolve_device(device)
    bsz, hh, ww, cin, cout = shape
    return time_rows(conv_rows(*inputs(shape, dev)),
                     2 * bsz * hh * ww * 9 * cin * cout, reps, runs, dev,
                     {"shape": list(shape)})


def bench_nin(shape, reps=50, runs=7, device="cuda"):
    dev = resolve_device(device)
    bsz, hh, ww, cin, cout = shape
    return time_rows(nin_rows(*inputs(shape, dev, nin=True)),
                     2 * bsz * hh * ww * cin * cout, reps, runs, dev,
                     {"shape": ["nin", bsz, hh, ww, cin, cout]})


def bench_gemm(n=GEMM_N, reps=30, runs=7, device="cuda"):
    dev = resolve_device(device)
    return time_rows(gemm_rows(n, dev), 2 * n ** 3, reps, runs, dev,
                     {"shape": ["gemm", n, n, n]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--gemm-only", action="store_true")
    ap.add_argument("--skip-gemm", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if not a.skip_gemm:
        print(json.dumps(bench_gemm(GEMM_N, reps=max(a.reps // 2, 5),
                                    runs=a.runs, device=a.device)),
              flush=True)
    if a.gemm_only:
        return 0
    for shape in SHAPES:
        print(json.dumps(bench_shape(shape, a.reps, a.runs, a.device)),
              flush=True)
    for shape in NIN_SHAPES:
        print(json.dumps(bench_nin(shape, a.reps, a.runs, a.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
