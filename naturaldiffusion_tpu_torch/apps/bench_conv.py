"""Micro-bench: the port's 3x3 conv kernels against cuDNN at the NCSN++
hot shapes (port of ``naturaldiffusion_tpu/apps/bench_conv.py``, shape
mode).

The JAX app times five Pallas variants of the 3x3 SAME conv against XLA's.
The port has one kernel per distinct function, so it prints one column per
kernel and names the JAX variants each one serves: K2 (``conv3x3``) serves
``taps9``, ``kstack`` and ``valid9``; K4 (``conv3x3_tiled``) serves
``tiled`` and ``tiledew``.  The ``xla`` column is ``F.conv2d`` (cuDNN,
channels-last, bf16).

    python -m naturaldiffusion_tpu_torch.apps.bench_conv [--reps 30] [--runs 7]

Prints one JSON line per shape with ms per call and TFLOP/s per column,
the faster kernel (``best_variant``, ``pallas_ms``) and its speedup over
cuDNN.  The backends are interleaved per run (the card drifts).
``--model``, the JAX app's in-model A/B of the conv routes, waits for the
port's counterpart of its trace-time route switch (ROADMAP.md, Queue A,
item conv-route).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.conv3x3 import conv3x3, conv3x3_tiled
from ..utils.profiling import Timer

# (B, H, W, C_in, C_out): every lane-aligned conv family of the CIFAR-10
# forward at micro-batch 64, and CelebA-HQ 256's level 0
SHAPES = [
    (64, 32, 32, 128, 128),   # res-32 resblock convs
    (64, 32, 32, 256, 128),   # res-32 up path (skip-concat input)
    (64, 16, 16, 256, 256),   # res-16 resblock convs
    (64, 16, 16, 512, 256),   # res-16 up path
    (64, 8, 8, 256, 256),     # res-8 resblock convs
    (4, 256, 256, 128, 128),  # celebahq-256 level-0 (tiled-only vs XLA)
]
SERVES = {"conv3x3": ["taps9", "kstack", "valid9"],
          "conv3x3_tiled": ["tiled", "tiledew"]}


def bench_shape(shape, reps=30, runs=7, dtype=torch.bfloat16, device="cuda"):
    dev = resolve_device(device)
    bsz, hh, ww, cin, cout = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((bsz, hh, ww, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
         * 0.05).to(dtype)
    bias = torch.zeros((cout,), dtype=dtype, device=dev)
    xcl = x.permute(0, 3, 1, 2)                   # NCHW view, channels-last
    wcl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def chain(fn):
        def run():
            for _ in range(reps):
                fn()
        return run

    fns = {"xla": chain(lambda: F.conv2d(xcl, wcl, bias, padding=1)),
           "conv3x3": chain(lambda: conv3x3(x, w, bias)),
           "conv3x3_tiled": chain(lambda: conv3x3_tiled(x, w, bias))}
    timer = Timer(iters=1, device=dev)
    for f in fns.values():
        timer.once(f)                             # warm-up: kernel builds
    times = {k: [] for k in fns}
    for _ in range(runs):                         # interleave: card drift
        for k, f in fns.items():
            times[k].append(timer.once(f))
    med = {k: statistics.median(v) / reps for k, v in times.items()}
    flops = 2 * bsz * hh * ww * 9 * cin * cout
    out = {"shape": list(shape)}
    for k, t in med.items():
        out[f"{k}_ms"] = t * 1e3
        out[f"{k}_tflops"] = flops / t / 1e12
    best = min(SERVES, key=lambda k: med[k])
    out["serves"] = SERVES
    out["pallas_ms"] = out[f"{best}_ms"]
    out["best_variant"] = best
    out["speedup"] = med["xla"] / med[best]
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--shapes", type=int, default=None,
                    help="bench only the first N shapes")
    ap.add_argument("--toy", action="store_true",
                    help="tiny shape, 2 reps -- smoke test of the app")
    ap.add_argument("--model", default=None, metavar="CONFIG",
                    help="the JAX app's in-model A/B: not ported yet")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model:
        raise NotImplementedError(
            "bench_conv --model is not ported yet: it A/Bs the conv routes "
            "by a trace-time switch the port's NCSN++ does not have yet "
            "(ROADMAP.md, Queue A, item conv-route)")
    shapes = [(2, 8, 8, 128, 128)] if args.toy else SHAPES[: args.shapes]
    reps, runs = (2, 1) if args.toy else (args.reps, args.runs)
    for shape in shapes:
        print(json.dumps(bench_shape(shape, reps=reps, runs=runs,
                                     device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    main()
