"""Weighted-sum degradation study (paper §3.2; port of
``naturaldiffusion_tpu/apps/degradation.py``, itself
``src/AnalyzeWeightedSumDegradation.py:93-232``).

For a feature set X = {x0_i} and a noisy sample x_t = alpha_t x0_i + noise,
compute the posterior p(x0_j | x_t) ∝ exp(-||x_t - x0_j||^2 / (2 sigma_rho^2))
over the whole set (sigma_rho = sqrt((1-abar)/abar), the rho
parameterisation) and record how concentrated it is on the sample's own x0:
the evidence that the weighted-sum denoiser's target degrades.

The reference reads VAE-encoded ImageNet latents from disk; pass
``--features feats.npz`` (array ``feats`` of [n, dim]), or ``--images DIR``
to VAE-encode a folder (``--vae`` torch weights, else random), or neither
for a synthetic Gaussian feature set (the statistic's shape does not
depend on the data).  The study runs on the card by default:

    python -m naturaldiffusion_tpu_torch.apps.degradation --kind vp
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..device import resolve_device


@torch.no_grad()
def posterior_stats(feats, t_index: int, *, kind: str = "vp",
                    seed: int = 200, noise=None, device="cuda"):
    """``(diag_probs [n], max_probs [n])`` at schedule index ``t_index``:
    each sample's posterior mass on its own x0, and the largest mass.
    ``noise`` (``[n, dim]``) replaces the draw from ``seed``.  Distances in
    float32 by the Gram identity (the reference uses ``torch.cdist``), the
    softmax in float64."""
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(feats), device=dev)
    n = f.shape[0]
    f = f.reshape(n, -1).to(torch.float32)
    if kind == "vp":
        betas = np.linspace(1e-4, 0.02, 1000)
        abar = np.cumprod(1.0 - betas)
        scale = np.sqrt(abar[t_index])
        noise_scale = np.sqrt(1.0 - abar[t_index])
        sigma = np.sqrt((1.0 - abar[t_index]) / abar[t_index])
    elif kind == "flow":
        data_scales = np.linspace(1.0, 1e-5, 1000)
        scale = data_scales[t_index]
        noise_scale = 1.0 - data_scales[t_index]
        sigma = (1.0 - data_scales[t_index]) / data_scales[t_index]
    else:
        raise ValueError(kind)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(f.shape, generator=gen, device=dev)
    else:
        noise = torch.as_tensor(np.array(noise, np.float32),
                                device=dev).reshape(f.shape)
    samples = f * float(scale) + noise * float(noise_scale)
    s2 = (samples ** 2).sum(dim=1, keepdim=True)
    f2 = (f ** 2).sum(dim=1)[None, :]
    d2 = s2 + f2 - 2.0 * samples @ f.T
    logits = (-d2 / (2.0 * float(sigma) ** 2)).to(torch.float64)
    probs = torch.softmax(logits, dim=1)
    return torch.diagonal(probs), probs.max(dim=1).values


def run_study(feats, t_indices, kind: str, outdir: str | None,
              device="cuda") -> list[dict]:
    """One line a schedule index (own-x0 mass, its share above 0.9, the
    mean max mass); with ``outdir`` also the two histograms as
    ``{kind}_{t}.npz``.  Returns the printed numbers."""
    rows = []
    for t in t_indices:
        diag, mx = posterior_stats(feats, t, kind=kind, device=device)
        diag, mx = diag.cpu().numpy(), mx.cpu().numpy()
        conc = (diag > 0.9).mean()
        print(f"{kind} t={t:<4d} own-x0 mass mean={diag.mean():.4f} "
              f"P(own>0.9)={conc:.4f} max-prob mean={mx.mean():.4f}",
              flush=True)
        rows.append(dict(t=t, own_mass=float(diag.mean()),
                         p_own_over_0_9=float(conc),
                         max_prob=float(mx.mean())))
        if outdir:
            hist_x0, _ = np.histogram(diag, bins=100, range=(0, 1))
            hist_xx, _ = np.histogram(mx, bins=100, range=(0, 1))
            os.makedirs(outdir, exist_ok=True)
            np.savez(os.path.join(outdir, f"{kind}_{t}.npz"),
                     hist_x0=hist_x0, hist_xx=hist_xx)
    return rows


@torch.no_grad()
def features_from_images(data_dir: str, *, vae_ckpt: str | None = None,
                         image_size: int = 256, batch: int = 16,
                         limit: int = 512, device="cuda",
                         vae=None) -> np.ndarray:
    """VAE-encode an image folder to flattened latent-mean features, the
    reference's ``get_feature``/``get_batch_feature_tx``
    (``src/AnalyzeWeightedSumDegradation.py:37-90``: AutoencoderKL encode,
    posterior mean, flatten).  ``vae``: an ``AutoencoderKL`` to use, else
    the SD VAE with ``vae_ckpt``'s weights (or random ones)."""
    from PIL import Image

    from ..data.image_folder import list_images, preprocess_image
    from ..models.vae import SD_VAE, AutoencoderKL, vae_torch_path_map

    dev = resolve_device(device)
    if vae is None:
        vae = AutoencoderKL(SD_VAE, device=dev)
        if vae_ckpt:
            from ..models.convert import fill_from_torch, load_torch_checkpoint
            fill_from_torch(vae, load_torch_checkpoint(vae_ckpt),
                            path_map=vae_torch_path_map)
    files = list_images(data_dir)[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {data_dir!r}")
    feats = []
    for start in range(0, len(files), batch):
        imgs = []
        for f in files[start:start + batch]:
            with Image.open(f) as im:
                imgs.append(preprocess_image(im, image_size, "crop_resize"))
        x = torch.as_tensor(np.stack(imgs), device=dev) * 2.0 - 1.0
        mean, _ = vae.encode(x)
        feats.append(mean.float().cpu().numpy().reshape(len(imgs), -1))
    return np.concatenate(feats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--features", default=None,
                   help="npz with array 'feats' [n, dim]")
    p.add_argument("--images", default=None,
                   help="image directory to VAE-encode into features "
                        "(the reference's ImageNet path)")
    p.add_argument("--vae", default=None, help="SD VAE torch weights")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--limit", type=int, default=512)
    p.add_argument("--kind", choices=("vp", "flow"), default="vp")
    p.add_argument("--t", type=lambda s: [int(x) for x in s.split(",")],
                   default=[200, 300, 400, 500, 600, 700, 800, 900])
    p.add_argument("--outdir", default=None)
    p.add_argument("--n", type=int, default=512,
                   help="synthetic feature count (no --features/--images)")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if args.features:
        feats = np.load(args.features)["feats"]
    elif args.images:
        feats = features_from_images(args.images, vae_ckpt=args.vae,
                                     image_size=args.image_size,
                                     limit=args.limit, device=dev)
        print(f"encoded {feats.shape[0]} images -> dim {feats.shape[1]}",
              flush=True)
    else:
        feats = np.random.default_rng(0).standard_normal(
            (args.n, args.dim)).astype(np.float32)
    run_study(feats, args.t, args.kind, args.outdir, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
