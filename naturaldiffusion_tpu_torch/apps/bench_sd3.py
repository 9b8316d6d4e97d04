"""SD3-medium Natural-Inference throughput on one card, the reference's
headline model (port of ``naturaldiffusion_tpu/apps/bench_sd3.py``).

Runs the 28-step sharpness-control loop (a CFG pair a step, the joint
attention over 4096 + context tokens at 1024 px) with random weights (the
same FLOPs as the safetensors) in bf16: the transformer's QDense products
on cuBLAS (kernel K7 under ``NATDIFF_QUANT=w8``), its joint attention on
kernel K9, each step's weighted sum on kernel K1.  The schedule-constant
conditioning is hoisted out of the loop unless ``--no-mods``.

    python -m naturaldiffusion_tpu_torch.apps.bench_sd3 [--latent 128]

Prints one JSON line with sec/image, the ms of a CFG forward per image
(``transformer_fwd_ms``) and the card's name and power limit
(``nvidia-smi``).  ``flops_per_fwd`` comes from the
config's shapes (``flops_source: "shapes"``); ``--flops-only`` prints the
FLOPs PyTorch's counter sees in one CPU forward and exits (use it with
``--toy``: the full model takes 8 GB of host memory in f32).  ``--trace
DIR`` writes a ``torch.profiler`` trace of one more run after the timed
ones; read it with ``python -m naturaldiffusion_tpu_torch.utils.
trace_summary DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from ..coeffs.sd3 import sd3_euler_weights
from ..device import resolve_device
from ..models.mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig
from ..utils.flops import H100_BF16_PEAK, flops_counted
from ..utils.profiling import trace
from .sd3_ni import make_cfg_fwd, make_cfg_fwd_mods, sd3_natural_inference

# the JAX app's --toy MMDiT (``naturaldiffusion_tpu/apps/bench_sd3.py:54``)
# at a latent of 8: 2 heads of 32
def toy_config(latent: int) -> MMDiTConfig:
    return MMDiTConfig(sample_size=max(latent, 8), patch_size=2,
                       in_channels=4, hidden_size=64, depth=2, num_heads=2,
                       caption_projection_dim=64, joint_attention_dim=32,
                       pooled_projection_dim=32, pos_embed_max_size=16)


def flops_per_forward(cfg: MMDiTConfig, batch: int, latent: int, ctx: int,
                      mods: bool) -> int:
    """Multiply-adds x 2 of one CFG forward at model batch ``2 * batch``:
    the patchify, every block's products on both streams (the last block's
    context stream stops after its q, k, v) and the joint attention, the
    output projection, and, without ``mods``, the conditioning MLPs, the
    adaLN products and the context embedder."""
    b2 = 2 * batch
    d, p, c = cfg.hidden_size, cfg.patch_size, cfg.in_channels
    tx = (latent // p) ** 2
    t = tx + ctx
    mx, mc = b2 * tx, b2 * ctx
    total = 2 * mx * p * p * c * d                            # patchify
    for i in range(cfg.depth):
        last = i == cfg.depth - 1
        total += 2 * mx * d * (3 * d + d + 8 * d)              # x stream
        total += 2 * mc * d * (3 * d + (0 if last else d + 8 * d))
        total += 4 * b2 * t * t * d                            # attention
    total += 2 * mx * d * p * p * c                            # proj_out
    if not mods:
        total += 2 * b2 * (256 * d + d * d + cfg.pooled_projection_dim * d
                           + d * d)                            # c MLPs
        total += 2 * b2 * d * d * (6 * cfg.depth + 6 * (cfg.depth - 1) + 2
                                   + 2)                        # adaLN
        total += 2 * mc * cfg.joint_attention_dim * d          # ctx embed
    return total


def count_forward_flops(cfg: MMDiTConfig, batch: int, latent: int, ctx: int,
                        mods: bool) -> int:
    """FLOPs of one CFG forward as PyTorch's counter sees them, on the CPU
    in float32 (the same products as bf16)."""
    model = MMDiT(cfg, device="cpu", seed=3)
    z = torch.zeros((batch, latent, latent, cfg.in_channels))
    context = torch.zeros((batch, ctx, cfg.joint_attention_dim))
    pooled = torch.zeros((batch, cfg.pooled_projection_dim))
    kw = dict(context=context, pooled=pooled, neg_context=context,
              neg_pooled=pooled)
    if not mods:
        return flops_counted(make_cfg_fwd(model, **kw), z, 500.0)
    fwd, aux = make_cfg_fwd_mods(model, t_all=torch.tensor([500.0]), **kw)
    step = {"blocks": tuple((a[0], c[0]) for a, c in aux["blocks"]),
            "out": aux["out"][0]}
    return flops_counted(fwd, z, 500.0, step)


def card_name(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or torch.cuda.get_device_name(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--latent", type=int, default=128,
                   help="latent H=W (128 = 1024px, 64 = 512px)")
    p.add_argument("--steps", type=int, default=28)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ctx", type=int, default=154,
                   help="context tokens (CLIP 77+77; +T5 for 333)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one more run here")
    p.add_argument("--no-mods", action="store_true",
                   help="recompute adaLN mods every step (A/B control)")
    p.add_argument("--toy", action="store_true",
                   help="tiny MMDiT (smoke tests; timing meaningless)")
    p.add_argument("--flops-only", action="store_true",
                   help="print the FLOPs of one CFG forward, counted on the "
                        "CPU, and exit")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = toy_config(args.latent) if args.toy else SD3_MEDIUM
    b, hw, n = args.batch, args.latent, args.steps
    if args.flops_only:
        print(count_forward_flops(cfg, b, hw, args.ctx, not args.no_mods),
              flush=True)
        return 0
    dev = resolve_device(args.device)
    quant = "w8" if os.environ.get("NATDIFF_QUANT", "") == "w8" else None
    model = MMDiT(cfg, quant=quant, device=dev, seed=3).to(torch.bfloat16)
    n_par = sum(a.numel() for a in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    z0 = rn(b, hw, hw, cfg.in_channels).to(torch.bfloat16)
    ctx = (0.02 * rn(b, args.ctx, cfg.joint_attention_dim)).bfloat16()
    pooled = (0.02 * rn(b, cfg.pooled_projection_dim)).bfloat16()
    cond = dict(context=ctx, pooled=pooled, neg_context=torch.zeros_like(ctx),
                neg_pooled=torch.zeros_like(pooled))
    w = sd3_euler_weights(n)

    def run():
        return sd3_natural_inference(model, z0, w, num_step=n,
                                     precompute_mods=not args.no_mods,
                                     **cond)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = run()                        # warm-up: kernel builds, quantization
    sync()
    ts = []
    for _ in range(3):                 # the median of 3, as the JAX app
        t0 = time.perf_counter()
        out = run()
        sync()
        ts.append(time.perf_counter() - t0)
    if not torch.isfinite(out).all():
        raise FloatingPointError("non-finite latents")
    if args.trace:
        with trace(args.trace):
            run()
    dt = statistics.median(ts)
    flops = flops_per_forward(cfg, b, hw, args.ctx, not args.no_mods)
    on_card = dev.type == "cuda"
    print(json.dumps({
        "model": ("toy-mmdit" if args.toy else "SD3-medium")
                 + f" ({n_par / 1e9:.2f}B params)",
        "latent": hw, "steps": n, "batch": b, "ctx": args.ctx,
        "mods": not args.no_mods, "quant": quant,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card_name(dev),
        "sec_per_image": dt / b,
        "transformer_fwd_ms": dt / (n * b) * 1e3,
        "img_per_min": 60.0 * b / dt,
        "flops_per_fwd": flops,
        "flops_source": "shapes",
        "mfu": flops * n / (dt * H100_BF16_PEAK) if on_card else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
