"""The FID pipeline at its reference scale (port of ``naturaldiffusion_tpu/
apps/fid_selfcheck.py``): the reference's 50k-sample loop
(``src/CIFAR10NaturalInference.py:288-313``: 100 batches of 500 -> 50,000
images -> InceptionV3 -> Frechet) on one card.

The reference's weights (``checkpoint_8.pth``, ``pt_inception``,
``cifar10_mu_sigma.npz``) are not in the repository, so no real FID can be
computed; the pipeline's behaviour at scale (memory, host transfers,
accumulation) does not depend on the weights.  This app runs the whole loop
with random weights (the same FLOPs) and checks the two properties the
Frechet estimator must have:

* **split-half self-FID ~ 0**: the features of the first and second half of
  the samples come from one distribution, so their Frechet distance is only
  the estimator's bias;
* **shifted-distribution FID >> 0**: a pixel-space shift of the same
  samples must score far worse.

The pass rule is the JAX package's: ``self_fid < 2.0`` and shifted/self
``> 50``.  Sampling is 10-step NI over the full-width CIFAR-10 NCSN++ in
bf16 (``cifar10_ni.make_sampler``); on a card each micro-batch is one
replay of a CUDA graph captured once (a capture that fails raises), and
``--device cpu`` runs the eager engine.  Artifacts: a CSV row
(``weights=random`` stamped), the statistics npz ``<out>_stats.npz``, and
wall-clock and steady rates of each stage.  With ``--ckpt``,
``--inception`` and ``--ref-stats`` the same code gives the
reference-comparable FID.

    python -m naturaldiffusion_tpu_torch.apps.fid_selfcheck [--num 50000]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np
import torch

from ..coeffs import registry
from ..coeffs.matrix import CoeffMatrix
from ..device import resolve_device
from ..eval.fid import (activations, compute_statistics, frechet_distance,
                        inception_score)
from ..models.ncsnpp import CIFAR10_DDPMPP_CONTINUOUS, NCSNpp, NCSNppConfig
from ..parallel import fold_in_shard, make_mesh, shard_batch
from .cifar10_ni import make_sampler

TOY = NCSNppConfig(nf=16, ch_mult=(1, 2), num_res_blocks=1,
                   attn_resolutions=(16,))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample_images(args, dev, model=None, mesh=None):
    """NI-sample ``args.num`` images on ``dev``; returns (images ``[num, 32,
    32, 3]`` on ``dev``, steady img/s, wall s).  ``model``: the NCSN++ to
    sample (default: a new one from seed 0, filled from ``--ckpt``).
    ``mesh``: data-parallel sampling, every batch padded to a multiple of
    the ranks (JAX ``apps/fid_selfcheck.py:45-77``)."""
    matrix = (CoeffMatrix.load(args.weights) if args.weights
              else registry.derive("ddpm", args.steps))
    if model is None:
        model = NCSNpp(TOY if args.toy else CIFAR10_DDPMPP_CONTINUOUS,
                       device=dev, seed=0)
        if args.ckpt:
            from ..models.convert import fill_from_torch, load_torch_checkpoint
            fill_from_torch(model, load_torch_checkpoint(args.ckpt))
    ndev = 1 if mesh is None else mesh.size()
    run = make_sampler(model, matrix, micro=args.micro, device=dev,
                       graph=dev.type == "cuda", mesh=mesh)

    # every batch is full (a graph takes one shape) and a multiple of the
    # ranks; the excess of the last is dropped
    b = args.batch + (-args.batch % ndev)
    nbatch = -(-args.num // args.batch)
    images = torch.empty((args.num, 32, 32, 3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noise_gen = gen if ndev == 1 else fold_in_shard(args.seed, mesh,
                                                    device=dev)
    wall0 = time.perf_counter()
    t0 = None
    done = first = 0
    for i in range(nbatch):
        init = torch.randn((b, 32, 32, 3), generator=gen, device=dev)
        if mesh is None:
            out = run(init, generator=noise_gen)
        else:
            out = run(shard_batch(mesh, init),
                      generator=noise_gen).full_tensor()
        take = min(args.batch, args.num - done)
        images[done:done + take] = out[:take]
        done += take
        if t0 is None:      # the first batch pays the warm-up and capture
            _sync(dev)
            t0, first = time.perf_counter(), done
        if i % 8 == 7 or done >= args.num:
            _sync(dev)
            rate = (done - first) / max(time.perf_counter() - t0, 1e-9) \
                if done > first else float("nan")
            print(f"  sample {done}/{args.num} ({rate:.1f} img/s steady)",
                  flush=True)
    _sync(dev)
    rate = (done - first) / max(time.perf_counter() - t0, 1e-9) \
        if done > first else float("nan")
    return images, rate, time.perf_counter() - wall0


def main(argv=None, model=None) -> int:
    """The app; ``model`` replaces the NCSN++ it would build (a caller that
    samples its own weights)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num", type=int, default=50000)   # the reference scale
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--micro", type=int, default=64)
    p.add_argument("--feat-batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=888)    # the reference seed
    p.add_argument("--ckpt", default=None, help="torch checkpoint_8.pth")
    p.add_argument("--weights", default=None, help="NI weight npz")
    p.add_argument("--inception", default=None,
                   help="pt_inception-2015-12-05.pth")
    p.add_argument("--ref-stats", default=None,
                   help="cifar10_mu_sigma.npz for a real FID number")
    p.add_argument("--no-is", action="store_true",
                   help="skip the Inception Score head (pool-only pass)")
    p.add_argument("--toy", action="store_true",
                   help="tiny NCSN++ (smoke tests; estimator checks only)")
    p.add_argument("--feat-dim", type=int, default=0,
                   help="use only the first D pool features (0 = all 2048). "
                        "For small runs: with N < ~2048 samples the full "
                        "covariances are rank-deficient and sqrtm raises, "
                        "as pytorch-fid's does at small N")
    p.add_argument("--out", default="results_torch/FID/selfcheck.csv")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    prov = "converted" if args.ckpt else "random"
    if args.toy:
        prov += "-toy"          # never mistakable for the full-size run
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}), weights={prov}", flush=True)

    mesh = make_mesh(device=dev)          # every rank of the process group
    print(f"mesh: {mesh.size()} rank(s)", flush=True)
    wall_start = time.perf_counter()
    images, sample_rate, sample_wall = sample_images(args, dev, model, mesh)
    if not torch.isfinite(images).all():
        raise FloatingPointError("the sampler produced non-finite pixels")

    # Inception features over all N: one pass gives the FID pool features
    # and the IS logits (deps/score_sde_pytorch/run_lib.py:175-407)
    from ..eval.inception import default_feature_fn
    with_logits = not args.no_is
    feature_fn = default_feature_fn(args.inception, with_logits=with_logits,
                                    device=dev)
    imgs01 = ((images + 1.0) * 0.5).clamp(0.0, 1.0)
    t0 = time.perf_counter()
    fmesh = mesh if mesh.size() > 1 else None
    feats = activations(imgs01, feature_fn, batch_size=args.feat_batch,
                        mesh=fmesh, pad_to_batch=True)
    feat_wall = time.perf_counter() - t0
    feat_rate = len(feats) / feat_wall
    print(f"  features {feats.shape} in {feat_wall:.1f}s "
          f"({feat_rate:.0f} img/s)", flush=True)
    is_mean = is_std = None
    if with_logits:
        logits = feats[:, 2048:].astype(np.float64)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        is_mean, is_std = inception_score(probs)
        feats = feats[:, :2048]
    if args.feat_dim:
        feats = feats[:, :args.feat_dim]

    # statistics and the estimator's two properties
    mu, sigma = compute_statistics(feats)
    half = len(feats) // 2
    mu_a, sig_a = compute_statistics(feats[:half])
    mu_b, sig_b = compute_statistics(feats[half:2 * half])
    self_fid = frechet_distance(mu_a, sig_a, mu_b, sig_b)

    # a pixel-space shift of the first half: must score >> 0
    shifted01 = (imgs01[:half] * 0.7 + 0.25).clamp(0.0, 1.0)
    t0 = time.perf_counter()
    feats_shift = activations(shifted01, feature_fn,
                              batch_size=args.feat_batch, mesh=fmesh,
                              pad_to_batch=True)[:, :2048]
    if args.feat_dim:
        feats_shift = feats_shift[:, :args.feat_dim]
    shift_wall = time.perf_counter() - t0
    mu_s, sig_s = compute_statistics(feats_shift)
    shifted_fid = frechet_distance(mu, sigma, mu_s, sig_s)

    real_fid = None
    if args.ref_stats:
        with np.load(args.ref_stats) as f:
            real_fid = frechet_distance(mu, sigma, f["mu"], f["sigma"])

    total_wall = time.perf_counter() - wall_start
    # random Inception weights make the absolute Frechet scale arbitrary
    # (the features span a near-degenerate subspace), so the check is
    # relative: the shifted distribution must score orders of magnitude
    # worse than the same-distribution split
    ratio = shifted_fid / max(self_fid, 1e-300)
    row = {
        "weights": prov,
        "inception": "converted" if args.inception else "random",
        "num": args.num, "steps": args.steps,
        "self_fid_25k_split": float(f"{self_fid:.6g}"),
        "shifted_fid": float(f"{shifted_fid:.6g}"),
        "shifted_over_self": float(f"{ratio:.4g}"),
        "fid_vs_ref_stats": round(real_fid, 4) if real_fid is not None
        else "",
        "is_mean": round(is_mean, 4) if is_mean is not None else "",
        "is_std": round(is_std, 4) if is_std is not None else "",
        "sample_img_per_sec": round(sample_rate, 1),
        "feature_img_per_sec": round(feat_rate, 1),
        "sample_wall_s": round(sample_wall, 1),
        "feature_wall_s": round(feat_wall + shift_wall, 1),
        "total_wall_s": round(total_wall, 1),
    }
    print(json.dumps(row), flush=True)

    ok = self_fid < 2.0 and ratio > 50.0
    if not ok:
        print(f"SELF-CHECK FAILED: self_fid={self_fid} "
              f"shifted_fid={shifted_fid} (ratio {ratio:.1f})", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(row.keys()))
        w.writeheader()
        w.writerow(row)
    np.savez(os.path.splitext(args.out)[0] + "_stats.npz",
             mu=mu, sigma=sigma, weights=np.asarray(prov))
    print(f"-> {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
