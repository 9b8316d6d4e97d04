"""DiT ImageNet-256 NI validation (port of ``naturaldiffusion_tpu/apps/
validate_dit.py``, the execution half of ``src/ValidateNaturalInference.py``).

Runs (a) the original skip-sampling recursion (DDPM ancestral or DDIM) and
(b) Natural Inference with the corresponding coefficient matrix, from the
same seed and CFG wrapper, and reports ``max|original - NI|`` against
``--tol`` times the latent scale: the reference's "You'll observe that
there is no difference" check (``:375-391``), made numerical.  Runs on the
card by default, in float32, with the weights of ``--ckpt`` (the release
``DiT-XL-2-256x256.pt`` layout) or random ones (the zero adaLN-Zero layers
perturbed so the network carries signal).  ``--vae`` (SD VAE torch
weights) decodes the first ``--batch`` latents of both trajectories, as
the reference does (``:368``: ``z / 0.18215``), to
``{outdir}/{alg}_{steps}__seed_{s}__{original,natural}.png``.

    python -m naturaldiffusion_tpu_torch.apps.validate_dit --steps 10
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from ..coeffs import registry
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..models.dit import DIT_CONFIGS, DiT, DiTConfig, forward_with_cfg
from ..schedules import DiscreteVP

# the JAX app's --small DiT (``naturaldiffusion_tpu/apps/validate_dit.py:31``):
# 4 heads of 16
SMALL = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                  depth=2, num_heads=4, num_classes=10)


@torch.no_grad()
def build_model(cfg: DiTConfig, device="cuda", seed: int = 0,
                ckpt: str | None = None) -> DiT:
    """The DiT of ``ckpt`` (a torch checkpoint through
    ``convert.fill_from_torch`` and ``dit_torch_path_map``), or a random
    one whose all-zero matrices (the adaLN-Zero layers and the final
    linear) get 0.02 N(0, 1), as the JAX app perturbs them."""
    model = DiT(cfg, device=device, seed=seed)
    if ckpt:
        from ..models.convert import fill_from_torch, load_torch_checkpoint
        from ..models.dit import dit_torch_path_map
        unused = fill_from_torch(model, load_torch_checkpoint(ckpt),
                                 path_map=dit_torch_path_map)
        print(f"loaded {ckpt} ({len(unused)} unused keys)", flush=True)
        return model
    gen = torch.Generator(device=model.pos_embed.device).manual_seed(7)
    for prm in model.parameters():
        if prm.dim() >= 2 and not bool(prm.any()):
            prm.normal_(0.0, 0.02, generator=gen)
    return model


@torch.no_grad()
def validate(model: DiT, *, alg: str = "ddim", steps: int = 24,
             cfg_scale: float = 4.0, batch: int = 2, seed: int = 0):
    """``(max|direct - NI|, max|NI|, direct, ni)`` for ``steps`` steps of
    ``alg``: the two final latents ``[2 * batch, H, W, C]`` (the CFG
    pair)."""
    cfg = model.config
    dev = model.pos_embed.device
    n, b, cin = steps, batch, cfg.in_channels
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (2 * b, cfg.input_size, cfg.input_size, cin)
    init = torch.randn(shape, generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (b,), generator=gen,
                           device=dev)
    # the reference CFG convention: first half conditional labels, second
    # half the null token (src/ValidateNaturalInference.py:343-344)
    y = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
    noises = torch.randn((n,) + shape, generator=gen, device=dev)

    def eps_fn(z, t):
        tb = torch.as_tensor(t, dtype=torch.float32,
                             device=dev).reshape(1).expand(z.shape[0])
        out = forward_with_cfg(model, z, tb, y, cfg_scale, cin)
        return out[..., :cin]                   # drop learned sigma

    # (a) direct skip-sampling over the respaced discrete grid
    sch = DiscreteVP.create(n)
    ts = sch.timesteps[::-1].astype(float)
    if alg == "ddim":
        c_xt, c_x0 = sch.ddim_coeff_xt[::-1], sch.ddim_coeff_x0[::-1]
        stds = [0.0] * n
    elif alg == "ddpm":
        c_xt, c_x0 = sch.ddpm_coeff_xt[::-1], sch.ddpm_coeff_x0[::-1]
        stds = sch.posterior_std[::-1]
    else:
        raise ValueError(f"alg must be ddim or ddpm, got {alg!r}")
    ab = sch.alphas_bar[::-1]
    z = init
    for k in range(n):
        eps = eps_fn(z, float(ts[k]))
        x0 = (z - math.sqrt(1 - ab[k]) * eps) / math.sqrt(ab[k])
        z = (float(c_xt[k]) * z + float(c_x0[k]) * x0
             + float(stds[k]) * noises[k])
    direct = z

    # (b) Natural Inference with the derived matrix, same seed
    sched = NISchedule.from_matrix(registry.derive(alg, n), device=dev)
    ni = natural_inference(eps_fn, sched, init,
                           noises=None if alg == "ddim" else noises,
                           prediction_type="eps")
    return (float((direct - ni).abs().max()), float(ni.abs().max()), direct,
            ni)


@torch.no_grad()
def decode_latents(vae, latents, batch: int):
    """The first ``batch`` latents through the VAE, unscaled first
    (``z / scaling_factor``): ``[batch, 8H, 8W, 3]`` images in [-1, 1]."""
    return vae.decode(vae.unscale_latents(latents[:batch]))


def load_vae(path: str, device):
    """The SD VAE (DiT's, ``models.vae.SD_VAE``) with the torch weights of
    ``path`` (the HF ``vae`` layout)."""
    from ..models.convert import fill_from_torch, load_torch_checkpoint
    from ..models.vae import SD_VAE, AutoencoderKL, vae_torch_path_map
    vae = AutoencoderKL(SD_VAE, device=device)
    fill_from_torch(vae, load_torch_checkpoint(path),
                    path_map=vae_torch_path_map)
    return vae


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--alg", choices=("ddpm", "ddim"), default="ddim")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--model", default="DiT-XL/2")
    p.add_argument("--ckpt", default=None, help="DiT-XL-2-256x256.pt")
    p.add_argument("--vae", default=None,
                   help="SD VAE torch weights: decode both trajectories")
    p.add_argument("--outdir", default="results_torch/validation",
                   help="where --vae writes its images")
    p.add_argument("--small", action="store_true",
                   help="tiny random DiT (smoke mode)")
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = SMALL if args.small else DIT_CONFIGS[args.model]
    model = build_model(cfg, device=dev, ckpt=args.ckpt)
    diff, scale, direct, ni = validate(
        model, alg=args.alg, steps=args.steps, cfg_scale=args.cfg_scale,
        batch=args.batch, seed=args.seed)
    ok = diff < args.tol * max(scale, 1.0)
    print(f"[{'OK ' if ok else 'FAIL'}] DiT {args.alg} steps={args.steps} "
          f"cfg={args.cfg_scale} max|original - NI| = {diff:.3e} "
          f"(latent scale {scale:.2f})", flush=True)
    if args.vae:
        from ..utils.plotting import save_image_grid
        vae = load_vae(args.vae, dev)
        for name, lat in (("original", direct), ("natural", ni)):
            path = os.path.join(args.outdir, f"{args.alg}_{args.steps:03d}__"
                                f"seed_{args.seed}__{name}.png")
            save_image_grid(decode_latents(vae, lat, args.batch), path,
                            nrow=args.batch)
            print(f"decoded -> {path}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
