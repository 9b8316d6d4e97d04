"""Score-SDE training-step throughput on one card (port of
``naturaldiffusion_tpu/apps/bench_train.py``).

The reference's training loop (``deps/score_sde_pytorch/run_lib.py:
127-173``, the loop that produced ``checkpoint_8.pth``) as a bench: the
whole train step (continuous DSM loss, forward and backward through the
NCSN++ VP with the kernels' Functions, Adam with warm-up and clip, EMA) on
CIFAR-shaped random data.

    python -m naturaldiffusion_tpu_torch.apps.bench_train [--batch 128]
        [--chain 8] [--bf16] [--micro M] [--remat]

``--chain`` steps make one timed run (synchronised at its end; the median
of 5 runs after one warm-up run), ``step_ms`` is a run over ``chain``.
FLOPs per step come from PyTorch's counter over ONE step on the CPU (the
kernels' plain versions are PyTorch operators there; on the card the
ctypes launches are invisible to it), at batch 1 times ``--batch``: every
counted product is per sample.  MFU is quoted against the H100's dense f32
(TF32 off, as this bench runs f32) and bf16 peaks.  Prints one JSON line
with the JAX app's keys, and the device, the conv switch and the peak
memory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from ..device import resolve_device
from ..models.ncsnpp import NCSNpp, NCSNppConfig
from ..sde import VPSDE
from ..train import make_train_step
from ..train.state import functional_apply
from ..utils.flops import H100_BF16_PEAK, flops_counted

# NVIDIA H100 SXM, dense f32 peak without TF32 (data sheet), at 700 W
H100_F32_PEAK = 67e12


def _steps(args, device, model=None):
    if model is None:
        model = NCSNpp(NCSNppConfig(nf=args.nf), device=device, seed=0)
    init_fn, step_fn = make_train_step(
        VPSDE(), functional_apply(model), warmup=5000, remat=args.remat,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        micro=args.micro)
    return model, init_fn(dict(model.named_parameters())), step_fn


def count_flops(args) -> int:
    """FLOPs of one train step at ``args.batch``: PyTorch's counter over one
    monolithic f32 step at batch 1 on the CPU, times the batch (JAX counts
    its monolithic step too: the math is the same with ``micro`` or in
    bf16)."""
    torch.manual_seed(0)
    one = argparse.Namespace(**dict(vars(args), bf16=False, micro=0))
    _, state, step = _steps(one, torch.device("cpu"))
    batch = torch.randn(1, 32, 32, 3)
    gen = torch.Generator().manual_seed(2)
    return flops_counted(step, state, gen, batch, with_grad=True) \
        * args.batch


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=128)   # reference default
    p.add_argument("--chain", type=int, default=8,
                   help="train steps per timed run")
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--remat", action="store_true",
                   help="torch.utils.checkpoint the model (memory for "
                        "FLOPs)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 forward and backward, f32 "
                        "master state")
    p.add_argument("--micro", type=int, default=0,
                   help="gradient-accumulation chunk size (0 = monolithic)")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="write a torch.profiler trace of one run here")
    p.add_argument("--flops", type=float, default=None,
                   help="FLOPs per step counted before (--flops-only)")
    p.add_argument("--flops-only", action="store_true",
                   help="print the FLOPs of one step and exit")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args, model=None):
    """The bench: ``(record, one_step)``, the JSON record and a closure
    that runs one more train step (for a caller's profiler).  ``model``: a
    float32 NCSN++ of ``args.nf`` on the device to train (its parameters
    are stepped in place), else a new one."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, state, step = _steps(args, dev, model)
    n_par = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = torch.randn(args.batch, 32, 32, 3, generator=gen, device=dev)

    def chain():
        loss = None
        for _ in range(args.chain):
            _, loss = step(state, gen, batch)
        return float(loss)                 # the host reads the last loss

    def timed():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = chain()
        return time.perf_counter() - t0, loss

    _, loss = timed()                      # warm-up
    if not loss == loss:
        raise FloatingPointError(f"non-finite loss {loss}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ts = [timed()[0] for _ in range(args.runs)]
    dt = statistics.median(ts) / args.chain
    if args.trace:
        from ..utils.profiling import trace
        with trace(args.trace):
            chain()
    flops = args.flops if args.flops is not None else count_flops(args)
    tflops = flops / dt / 1e12
    rec = {
        "model": f"ncsnpp-vp ({n_par / 1e6:.1f}M params)",
        "batch": args.batch, "chain": args.chain, "remat": args.remat,
        "bf16": args.bf16, "micro": args.micro,
        "step_ms": dt * 1e3,
        "img_per_sec": args.batch / dt,
        "flops_per_step": flops,
        "flops_source": "counted-single-step-cpu-batch1-scaled",
        "tflops": tflops,
        "mfu_vs_f32_peak": tflops * 1e12 / H100_F32_PEAK,
        "mfu_vs_bf16_peak": tflops * 1e12 / H100_BF16_PEAK,
        "device": str(dev),
        "conv_switch": os.environ.get("NATDIFF_PALLAS_CONV", "2"),
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "loss": loss,
    }
    return rec, lambda: step(state, gen, batch)


def main(argv=None) -> int:
    args = parse(argv)
    if args.flops_only:
        print(count_flops(args))
        return 0
    rec, _ = run(args)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
