"""Generative round trip: train -> snapshots -> 10-step NI -> FID curve (port
of ``naturaldiffusion_tpu/apps/roundtrip.py``).

The real-data version of this loop (``src/CIFAR10NaturalInference.py:
241-317``, sampling a trained ``checkpoint_8.pth`` and scoring FID) needs
weights the repository does not hold, so this driver runs the same
pipeline on the procedural distribution of ``apps/toy_dataset.py``:

1. the dataset's statistics through the FID stack (the batch loader ->
   InceptionV3 features -> mu/sigma), the split-half FID *floor* and the
   ground-truth scalar marginals (``summary_stats``);
2. for every training snapshot in ``--workdir`` (and the random init as
   step 0): restore the state, load its EMA weights into the sampler's copy
   (``cifar10_ni.make_sampler(...).with_params``), sample ``--num`` images
   by 10-step NI, and score FID and each marginal's Wasserstein-1 against
   the dataset;
3. write a CSV (one row a snapshot) and a sample grid a snapshot.

A healthy run shows FID and every W1 column falling toward the floor.
Without ``--inception`` weights the features are the seeded random-init
InceptionV3 (a valid discriminative metric for this comparison, not a
published FID; the CSV stamps it); ``--features toy`` is a small seeded
random-conv extractor for quick runs.

    python -m naturaldiffusion_tpu_torch.apps.roundtrip \\
        --workdir /tmp/run --data-dir /tmp/toy_cifar
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..coeffs import registry
from ..data.native_loader import NativeBatchLoader
from ..device import resolve_device
from ..eval.fid import activations, compute_statistics, frechet_distance
from ..eval.inception import default_feature_fn
from ..models.ncsnpp import NCSNpp, NCSNppConfig
from ..sde import VESDE, SubVPSDE, VPSDE
from ..train import checkpoint as ckpt
from ..train import make_train_step
from ..train.state import functional_apply
from ..utils.plotting import save_image_grid
from .cifar10_ni import make_sampler
from .toy_dataset import summary_stats, wasserstein1

_SDES = {"vpsde": VPSDE, "subvpsde": SubVPSDE, "vesde": VESDE}


def toy_feature_fn(dim: int = 256, device="cuda"):
    """A fixed random-conv extractor (three stride-2 3x3 convs with GELU, a
    spatial mean; weights from seed 7) for quick runs: ``fn(images [N, H,
    W, 3] in [0, 1]) -> [N, dim]``.  Deterministic, so runs compare."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(7)
    ws = []
    for cin, cout in ((3, 32), (32, 64), (64, dim)):
        ws.append(((torch.randn(cout, cin, 3, 3, generator=g)
                    / (9 * cin) ** 0.5).to(dev), torch.zeros(cout,
                                                               device=dev)))

    @torch.no_grad()
    def fn(images):
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                            device=dev).permute(0, 3, 1, 2)
        for w, b in ws:
            x = F.gelu(F.conv2d(x, w, b, stride=2, padding=1))
        return x.mean(dim=(2, 3))
    return fn


def dataset_side(args, feature_fn):
    """Eval-split features -> (mu, sigma), the split-half FID floor, the
    scalar marginals and their split-half W1 floors."""
    loader = NativeBatchLoader([os.path.join(args.data_dir,
                                             "test_batch.bin")])
    n = min(len(loader), args.eval_n)
    images, _ = loader.gather(np.arange(n))          # float32 in [0, 1]
    feats = activations(images, feature_fn, batch_size=args.feat_batch)
    mu, sigma = compute_statistics(feats)
    half = n // 2
    floor = frechet_distance(*compute_statistics(feats[:half]),
                             *compute_statistics(feats[half:]))
    marg = summary_stats(images)
    marg_floor = {k: wasserstein1(v[:half], v[half:])
                  for k, v in marg.items()}
    return images, mu, sigma, floor, marg, marg_floor


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--sde", default="vpsde", choices=sorted(_SDES))
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--ch-mult", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(1, 2, 2, 2))
    p.add_argument("--num-res-blocks", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--num", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--micro", type=int, default=64)
    p.add_argument("--feat-batch", type=int, default=256)
    p.add_argument("--eval-n", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=888)
    p.add_argument("--inception", default=None,
                   help="pt_inception .pth (random-init features if absent)")
    p.add_argument("--features", default="inception",
                   choices=("inception", "toy"),
                   help="'toy' = small random-conv extractor")
    p.add_argument("--snapshots", type=int, nargs="*", default=None,
                   help="specific snapshot steps (default: all + step 0)")
    p.add_argument("--out", default=None)
    p.add_argument("--grid-dir", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    out = args.out or os.path.join(args.workdir, "roundtrip.csv")
    grid_dir = args.grid_dir or os.path.join(args.workdir, "grids")
    os.makedirs(grid_dir, exist_ok=True)
    if args.features == "toy":
        feature_fn, feat_prov = toy_feature_fn(device=dev), "toy-conv"
    else:
        feature_fn = default_feature_fn(args.inception, device=dev)
        feat_prov = "converted" if args.inception else "random-init"
    print(f"dataset side (features: {feat_prov}) ...", flush=True)
    _, mu, sigma, floor, marg, marg_floor = dataset_side(args, feature_fn)
    print(f"eval floor: split-half FID {floor:.4f}; W1 floors " +
          " ".join(f"{k}={v:.4f}" for k, v in marg_floor.items()),
          flush=True)

    # the train state's template as apps/train.py builds it
    model = NCSNpp(NCSNppConfig(nf=args.nf, ch_mult=tuple(args.ch_mult),
                                num_res_blocks=args.num_res_blocks),
                   device=dev, seed=42)
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init_fn, _ = make_train_step(_SDES[args.sde](), functional_apply(model))
    template = init_fn(dict(model.named_parameters()))
    snaps = args.snapshots
    if snaps is None:
        snaps = sorted(int(os.path.basename(d).split("_")[1]) for d in
                       glob.glob(os.path.join(
                           args.workdir, "checkpoints", "checkpoint_*")))
        snaps = [0] + snaps                     # random init = the baseline
    run = make_sampler(model, registry.derive("ddpm", args.steps),
                       micro=args.micro, device=dev)

    rows = []

    def sink():
        with open(out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)

    for s in snaps:
        if s == 0:
            weights = params0
        else:
            path = os.path.join(args.workdir, "checkpoints",
                                f"checkpoint_{s}")
            state = ckpt.restore(path, template)
            if state.step == 0:
                print(f"snapshot {s}: restore failed, skipping")
                continue
            weights = dict(params0, **dict(zip(state.params,
                                               state.ema.shadow)))
        run.with_params(weights)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        images, t0, done, first = [], None, 0, 0
        while done < args.num:
            b = min(args.batch, args.num - done)
            init = torch.randn((b, 32, 32, 3), generator=gen, device=dev)
            images.append(run(init, generator=gen).cpu().numpy())
            if t0 is None:                      # the first batch warms up
                t0, first = time.time(), done + b
            done += b
        wall = time.time() - t0
        images = np.concatenate(images)[:args.num]
        rate = (done - first) / max(wall, 1e-9) if done > first else 0.0

        imgs01 = np.clip((images + 1.0) / 2.0, 0.0, 1.0)
        feats = activations(imgs01, feature_fn, batch_size=args.feat_batch)
        fid = frechet_distance(*compute_statistics(feats), mu, sigma)
        stats = summary_stats(imgs01)
        row = {"step": s, "features": feat_prov, "weights": "ema",
               "num": args.num, "ni_steps": args.steps,
               "fid": round(fid, 4), "fid_floor": round(floor, 4)}
        for k in stats:
            row[f"w1_{k}"] = round(wasserstein1(stats[k], marg[k]), 5)
            row[f"w1_{k}_floor"] = round(marg_floor[k], 5)
        row["finite"] = bool(np.isfinite(images).all())
        row["img_per_sec"] = round(rate, 1)
        rows.append(row)
        print(row, flush=True)
        sink()
        save_image_grid(images[:64], os.path.join(grid_dir, f"step_{s}.png"))
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
