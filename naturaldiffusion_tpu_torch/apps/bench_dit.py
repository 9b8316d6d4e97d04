"""DiT ImageNet-256 Natural-Inference throughput on one card (port of
``naturaldiffusion_tpu/apps/bench_dit.py``).

The reference's DiT validation workload (``src/ValidateNaturalInference.py:
336-382``: DDIM skip-sampling == NI on DiT-XL/2) as an end-to-end
inference bench: n-step deterministic NI with the reference CFG wrapper
(batch-doubled call, guide-only-``in_channels`` quirk), random weights
(the same FLOPs as ``DiT-XL-2-256x256.pt``), bf16 activations, f32
accumulation.  The schedule-constant conditioning is hoisted out of the
loop (``dit_schedule_mods``) unless ``--no-mods``.  ``NATDIFF_QUANT=w8``
runs every ``QDense`` that passes ``qmatmul_ok`` through the W8A16 kernel.

    python -m naturaldiffusion_tpu_torch.apps.bench_dit [--steps 50] [--batch 1]

Prints one JSON line.  ``flops_per_fwd`` comes from the config's shapes
(the matrix products and attention of one CFG forward,
``flops_source: "shapes"``), or with ``--count-flops`` from PyTorch's FLOP
counter over one CPU forward in a subprocess (``"counted"``); the MFU
divides it by the H100's published dense bf16 peak.  ``--flops-only``
prints that counted number and exits, on the CPU.  ``--trace DIR`` writes a
``torch.profiler`` trace of one more run after the timed ones (as the JAX
app does, so the profiler's cost stays out of the times); read it with
``python -m naturaldiffusion_tpu_torch.utils.trace_summary DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from ..coeffs import registry
from ..coeffs.matrix import CoeffMatrix
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..models.dit import (DIT_CONFIGS, DiT, DiTConfig, dit_schedule_mods,
                          forward_with_cfg)
from ..utils.flops import (H100_BF16_PEAK, flops_counted,
                           flops_via_cpu_subprocess)
from ..utils.profiling import trace
# the JAX app's --toy DiT (``naturaldiffusion_tpu/apps/bench_dit.py:53``):
# 2 heads of 32
TOY = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                depth=2, num_heads=2, num_classes=10)


def flops_per_forward(cfg: DiTConfig, batch: int, mods: bool) -> int:
    """Multiply-adds x 2 of one CFG forward at model batch ``2 * batch``:
    patchify, every block's four dense products and attention, the final
    linear, and, without ``mods``, the embedders and adaLN products."""
    b2 = 2 * batch
    d, p, h = cfg.hidden_size, cfg.patch_size, cfg.num_heads
    t = (cfg.input_size // p) ** 2
    m = b2 * t
    hidden = int(d * cfg.mlp_ratio)
    block = 2 * m * d * (3 * d + d + 2 * hidden) + 4 * b2 * t * t * d
    total = (2 * m * p * p * cfg.in_channels * d + cfg.depth * block
             + 2 * m * d * p * p * cfg.out_channels)
    if not mods:
        total += 2 * b2 * (256 * d + d * d)                 # t_embedder
        total += 2 * b2 * d * (6 * d * cfg.depth + 2 * d)   # adaLN
    return total


def count_forward_flops(cfg: DiTConfig, batch: int, cfg_scale: float,
                        mods: bool) -> int:
    """FLOPs of one CFG forward at model batch ``2 * batch`` as PyTorch's
    counter sees them, on the CPU in float32 (the same products as bf16),
    with the modulations hoisted when ``mods``, as the timed run has them."""
    model = DiT(cfg, device="cpu", seed=2)
    z = torch.zeros((2 * batch, cfg.input_size, cfg.input_size,
                     cfg.in_channels))
    y = torch.zeros((2 * batch,), dtype=torch.long)
    t = torch.full((2 * batch,), 500.0)
    m = None
    if mods:
        m = dit_schedule_mods(model, t[:1], y)
        m = {"blocks": tuple(a[0] for a in m["blocks"]),
             "final": m["final"][0]}
    return flops_counted(lambda zz: forward_with_cfg(
        lambda xx, tt, yy: model(xx, tt, yy, mods=m), zz, t, y, cfg_scale,
        cfg.in_channels), z)


def make_sampler(model: DiT, matrix: CoeffMatrix, *, cfg_scale: float = 4.0,
                 mods: bool = True):
    """``run(z0, y) -> z`` (float32): NI over ``matrix`` with the CFG
    wrapper, eps taken as the first ``in_channels`` outputs.  ``z0``:
    ``[2B, H, W, C]`` in the model's type (both halves the same latents),
    ``y``: ``[2B]`` labels ``[cond..., null...]``.  With ``mods`` the
    conditioning of all steps is computed first, inside ``run``."""
    cin = model.config.in_channels
    sched = NISchedule.from_matrix(matrix, device=model.pos_embed.device)
    n = sched.num_step

    @torch.no_grad()
    def run(z0, y):
        def fwd(zz, t, mods_k=None):
            tb = t.reshape(1).expand(zz.shape[0])
            out = forward_with_cfg(
                lambda xx, tt, yy: model(xx, tt, yy, mods=mods_k),
                zz, tb, y, cfg_scale, cin)
            return out[..., :cin]

        aux = dit_schedule_mods(model, sched.node[:n, 0], y) if mods else None
        return natural_inference(fwd, sched, z0, prediction_type="eps",
                                 step_inputs=aux)

    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="DiT-XL/2")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=1,
                   help="images per run (model batch is 2x: CFG pair)")
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--no-mods", action="store_true",
                   help="recompute adaLN mods every step (A/B control)")
    p.add_argument("--toy", action="store_true",
                   help="tiny DiT (smoke tests; timing meaningless)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one more run here")
    p.add_argument("--count-flops", action="store_true",
                   help="count flops_per_fwd on the CPU (a --flops-only "
                        "subprocess) instead of from the shapes")
    p.add_argument("--flops-only", action="store_true",
                   help="print the FLOPs of one CFG forward, counted on the "
                        "CPU, and exit")
    args = p.parse_args(argv)

    cfg = TOY if args.toy else DIT_CONFIGS[args.model]
    if args.flops_only:
        print(count_forward_flops(cfg, args.batch, args.cfg_scale,
                                  not args.no_mods), flush=True)
        return 0
    dev = resolve_device(args.device)
    quant = "w8" if os.environ.get("NATDIFF_QUANT", "") == "w8" else None
    model = DiT(cfg, quant=quant, device=dev, seed=2).to(torch.bfloat16)
    n_par = sum(a.numel() for a in model.parameters())
    b, n, cin = args.batch, args.steps, cfg.in_channels

    gen = torch.Generator(device=dev).manual_seed(0)
    half = torch.randn((b, cfg.input_size, cfg.input_size, cin),
                       generator=gen, device=dev)
    # reference CFG convention: both batch halves carry the same latents,
    # labels are [cond..., null...] (src/ValidateNaturalInference.py:343-344)
    z0 = torch.cat([half, half]).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen,
                           device=dev)
    y = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
    run = make_sampler(model, registry.derive("ddim", n),
                       cfg_scale=args.cfg_scale, mods=not args.no_mods)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = run(z0, y)                   # warm-up: kernel builds, quantization
    sync()
    ts = []
    for _ in range(5):                 # the median of 5, as the JAX app
        t0 = time.perf_counter()
        out = run(z0, y)
        sync()
        ts.append(time.perf_counter() - t0)
    if not torch.isfinite(out).all():
        raise FloatingPointError("non-finite latents")
    if args.trace:
        with trace(args.trace):
            run(z0, y)
    dt = statistics.median(ts)
    if args.count_flops:
        sub = ["--model", args.model, "--batch", str(b), "--cfg-scale",
               str(args.cfg_scale)]
        sub += (["--no-mods"] if args.no_mods else []) + (
            ["--toy"] if args.toy else [])
        flops = int(flops_via_cpu_subprocess(
            "naturaldiffusion_tpu_torch.apps.bench_dit", sub))
        flops_source = "counted"
    else:
        flops = flops_per_forward(cfg, b, not args.no_mods)
        flops_source = "shapes"
    on_card = dev.type == "cuda"
    print(json.dumps({
        "model": ("toy-dit" if args.toy else args.model)
                 + f" ({n_par / 1e6:.0f}M params)",
        "steps": n, "batch": b, "mods": not args.no_mods, "quant": quant,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "sec_per_image": dt / b,
        "transformer_fwd_ms": dt / (n * b) * 1e3,
        "img_per_min": 60.0 * b / dt,
        "flops_per_fwd": flops,
        "flops_source": flops_source,
        "mfu": flops * n / (dt * H100_BF16_PEAK) if on_card else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
