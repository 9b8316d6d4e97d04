"""Controllable generation with trained weights: inpaint and colorize (port
of ``naturaldiffusion_tpu/apps/controllable_eval.py``).

Drives ``samplers/controllable.py`` (reference
``deps/score_sde_pytorch/controllable_generation.py:8-180``) with the EMA
weights of a training state from ``apps/train.py`` (the toy-CIFAR model of
``apps/toy_dataset.py``): masks the center of held-out toy images and
inpaints, decouples luminance and colorizes, and writes PNG grids and the
masked- and known-region MSEs.

    python -m naturaldiffusion_tpu_torch.apps.controllable_eval \\
        --workdir /tmp/roundtrip_work --outdir results_torch/controllable

The model-space scaler is the centered [-1, 1] map used by training.  Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..data import get_inverse_scaler
from ..device import resolve_device
from ..models.ncsnpp import NCSNpp, NCSNppConfig
from ..samplers.controllable import (couple, decouple, get_pc_colorizer,
                                     get_pc_inpainter)
from ..sde import VPSDE, get_score_fn
from ..utils.plotting import save_image_grid
from .quant_accuracy import load_ema
from .toy_dataset import draw_params, render


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True,
                   help="apps/train.py workdir with a restorable state")
    p.add_argument("--outdir", required=True)
    p.add_argument("--num", type=int, default=16)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--mask", type=int, default=12,
                   help="side of the unknown center square (px)")
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--ch-mult", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(1, 2, 2, 2))
    p.add_argument("--num-res-blocks", type=int, default=4)
    p.add_argument("--snr", type=float, default=0.16)
    p.add_argument("--predictor", default="reverse_diffusion",
                   help="reference controllable default; the VP-config "
                        "PC choice is euler_maruyama")
    p.add_argument("--corrector", default="langevin",
                   help="'none' = predictor-only (the reference's vpsde "
                        "cifar10 PC config)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    sde = VPSDE()
    model = NCSNpp(NCSNppConfig(nf=args.nf, ch_mult=args.ch_mult,
                                num_res_blocks=args.num_res_blocks),
                   device=dev, seed=0).eval()
    weights = load_ema(model, args.workdir)
    if weights == "random":
        raise SystemExit(f"no restorable snapshot under {args.workdir}")
    step = int(weights[len("ema_step"):])
    print(f"restored step-{step} EMA params", flush=True)

    # held-out toy images (eval-range indices), centered model space
    prm = draw_params(60_000)
    imgs01 = render(prm, 50_000, 50_000 + args.num)          # [0, 1]
    data = torch.from_numpy(imgs01.astype(np.float32) / 255.0).to(dev) \
        * 2.0 - 1.0
    inv = get_inverse_scaler(True)
    score_fn = get_score_fn(sde, model)

    # center-square inpainting mask: 1 == known pixel
    m = np.ones((1, 32, 32, 1), np.float32)
    lo, hi = 16 - args.mask // 2, 16 + args.mask // 2
    m[:, lo:hi, lo:hi, :] = 0.0
    mask = torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(m, data.shape))).to(dev)
    kw = dict(snr=args.snr, predictor=args.predictor,
              corrector=args.corrector, inverse_scaler=inv, device=dev)
    inpaint = get_pc_inpainter(sde, score_fn, **kw)
    colorize = get_pc_colorizer(sde, score_fn, **kw)
    gray = couple(decouple(data) * torch.tensor([1.0, 0.0, 0.0],
                                                device=dev))
    out = {"step": step, "num": args.num, "mask_px": args.mask,
           "seeds": []}
    orig01 = inv(data).cpu().numpy()
    save_image_grid(orig01, f"{args.outdir}/original.png",
                    value_range=(0.0, 1.0))
    save_image_grid(inv(data * mask - (1.0 - mask)).cpu().numpy(),
                    f"{args.outdir}/masked_input.png", value_range=(0.0, 1.0))
    save_image_grid(inv(gray).cpu().numpy(), f"{args.outdir}/gray_input.png",
                    value_range=(0.0, 1.0))
    known = mask.bool().cpu().numpy()[..., :1].repeat(3, axis=-1)
    for s in range(args.seeds):
        t0 = time.time()
        ip = inpaint(torch.Generator(device=dev).manual_seed(10 + s), data,
                     mask).cpu().numpy()
        t_ip = time.time() - t0
        t0 = time.time()
        co = colorize(torch.Generator(device=dev).manual_seed(20 + s), gray)
        t_co = time.time() - t0
        # the colorizer keeps the decoupled luminance channel
        lum_out = decouple(co * 2.0 - 1.0)[..., 0].cpu().numpy()
        lum_in = decouple(gray)[..., 0].cpu().numpy()
        co = co.cpu().numpy()
        row = {
            "seed": s,
            "predictor": args.predictor, "corrector": args.corrector,
            "inpaint_absmax": float(np.abs(ip).max()),
            "colorize_absmax": float(np.abs(co).max()),
            "inpaint_finite": bool(np.isfinite(ip).all()),
            "inpaint_known_mse": float(((ip - orig01)[known] ** 2).mean()),
            "inpaint_masked_mse": float(((ip - orig01)[~known] ** 2).mean()),
            "inpaint_wall_s": round(t_ip, 1),
            "colorize_finite": bool(np.isfinite(co).all()),
            "colorize_lum_mse": float(((lum_out - lum_in) ** 2).mean()),
            "colorize_rgb_mse": float(((co - orig01) ** 2).mean()),
            "colorize_wall_s": round(t_co, 1),
        }
        out["seeds"].append(row)
        save_image_grid(ip, f"{args.outdir}/inpaint_seed{s}.png",
                        value_range=(0.0, 1.0))
        save_image_grid(co, f"{args.outdir}/colorize_seed{s}.png",
                        value_range=(0.0, 1.0))
        print(json.dumps(row), flush=True)
    with open(f"{args.outdir}/controllable.json", "w") as fh:
        json.dump(out, fh, indent=1)
    ok = all(r["inpaint_finite"] and r["colorize_finite"]
             for r in out["seeds"])
    print(f"controllable_eval: {'ok' if ok else 'NON-FINITE OUTPUT'} "
          f"-> {args.outdir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
