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

    python -m naturaldiffusion_tpu_torch.apps.bench_conv \
        --model ve/celebahq_256_ncsnpp_continuous [--batch 2 --reps 4]

``--model CONFIG`` is the JAX app's in-model A/B (``bench_model``): one
NCSN++ forward of the config, bf16, every weight random from a seed, per
route of the conv switch, with the JAX app's labels so the two outputs
compare line by line: ``xla`` (``NATDIFF_PALLAS_CONV=0``: here the
library route, cuDNN), ``pallas_tiled`` and ``pallas_tiledew`` (``1``
with ``NATDIFF_CONV_TILED`` ``tiled`` / ``tiledew``: both run K2 and K4,
one function, so they differ only by the card's noise), ``pallas_fused``
(``2``).  Each prints ``<label>_ms`` (median over runs of a forward),
``<label>_img_s``, or ``<label>_error`` where the route raised; runs are
interleaved across the routes, each timed by CUDA events around ``reps``
forwards with one synchronize.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

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


# (label, NATDIFF_PALLAS_CONV, NATDIFF_CONV_TILED): the JAX app's modes
MODEL_MODES = (("xla", "0", None), ("pallas_tiled", "1", "tiled"),
               ("pallas_tiledew", "1", "tiledew"),
               ("pallas_fused", "2", "tiledew"))


def bench_model(name, batch=2, reps=4, runs=5, dtype=torch.bfloat16,
                device="cuda", seed=0):
    """One forward of config ``name`` per route of the conv switch (see the
    module docstring); the JSON record of the JAX app's ``bench_model``."""
    from .. import configs
    from ..models.convert import randomize_
    from ..models.ncsnpp import NCSNpp

    dev = resolve_device(device)
    cfg = configs.get_config(name)
    if cfg.model_family != "ncsnpp":
        raise ValueError(f"{name} is a {cfg.model_family} config; the "
                         f"in-model A/B runs NCSN++ configs")
    model = randomize_(NCSNpp(cfg.model, device="cpu"), seed)
    model = model.to(device=dev, dtype=dtype).eval()
    sz, ch = cfg.model.image_size, cfg.model.num_channels
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((batch, sz, sz, ch), generator=gen).to(dev, dtype)
    t = torch.full((batch,), 500.0, device=dev)
    on_card = dev.type == "cuda"

    def chain():
        with torch.no_grad():
            for _ in range(reps):
                model(x, t)

    def timed():
        if not on_card:
            t0 = time.perf_counter()
            chain()
            return time.perf_counter() - t0
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        chain()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / 1e3

    out = {"model": name, "batch": batch, "reps": reps}
    keys = ("NATDIFF_PALLAS_CONV", "NATDIFF_CONV_TILED")
    saved = {k: os.environ.get(k) for k in keys}

    def use(flag, tform):
        os.environ["NATDIFF_PALLAS_CONV"] = flag
        if tform is not None:
            os.environ["NATDIFF_CONV_TILED"] = tform

    try:
        live = []
        for label, flag, tform in MODEL_MODES:
            use(flag, tform)
            try:
                timed()                          # warm-up: kernel builds
            except Exception as e:               # the JAX app's record
                out[f"{label}_error"] = f"{type(e).__name__}: {str(e)[:200]}"
                continue
            live.append((label, flag, tform))
        times = {label: [] for label, _, _ in live}
        for _ in range(runs):                    # interleave: card drift
            for label, flag, tform in live:
                use(flag, tform)
                times[label].append(timed())
        for label, ts in times.items():
            med = statistics.median(ts) / reps
            out[f"{label}_ms"] = round(med * 1e3, 2)
            out[f"{label}_img_s"] = round(batch / med, 2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["device"] = (torch.cuda.get_device_name(dev) if on_card else "cpu")
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
                    help="in-model A/B of the conv routes at this config "
                         "(e.g. ve/celebahq_256_ncsnpp_continuous)")
    ap.add_argument("--batch", type=int, default=2,
                    help="--model: images a forward")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model:
        print(json.dumps(bench_model(args.model, batch=args.batch,
                                     runs=args.runs, device=args.device)),
              flush=True)
        return 0
    shapes = [(2, 8, 8, 128, 128)] if args.toy else SHAPES[: args.shapes]
    reps, runs = (2, 1) if args.toy else (args.reps, args.runs)
    for shape in shapes:
        print(json.dumps(bench_shape(shape, reps=reps, runs=runs,
                                     device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    main()
