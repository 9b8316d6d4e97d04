"""Dataset FID statistics: the ``cifar10_mu_sigma.npz`` producer (port of
``naturaldiffusion_tpu/apps/fid_stats.py``).

The reference reads ``weights/cifar10_mu_sigma.npz`` (mu and sigma of the
InceptionV3 features over the dataset, ``src/CIFAR10NaturalInference.py:
98,189,312``), which is not in the repository.  This app makes it: the batch
loader (``data.native_loader``, its backend printed) -> the port's
InceptionV3 on the card -> ``{mu, sigma, weights}`` npz in the layout that
``eval.fid.fid_from_samples`` reads.  With ``--inception
pt_inception-2015-12-05.pth`` the statistics are pytorch-fid's; without it
the extractor has random weights (``weights=random`` in the npz), which
runs the pipeline and nothing more.

    python -m naturaldiffusion_tpu_torch.apps.fid_stats \\
        --data cifar-10-batches-bin/data_batch_*.bin \\
        --inception pt_inception-2015-12-05.pth --out cifar10_mu_sigma.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def compute_dataset_stats(loader, feature_fn, *, batch_size: int = 256,
                          limit: int | None = None, mesh=None):
    """The whole dataset in order, no augmentation, through the feature
    extractor; returns ``(mu, sigma, n)``.  ``mesh``: the features run
    data-parallel (``eval.fid.activations(mesh=)``)."""
    from ..eval.fid import activations, compute_statistics

    n = len(loader) if limit is None else min(limit, len(loader))
    feats = []
    for start in range(0, n, batch_size):
        images, _ = loader.gather(np.arange(start, min(start + batch_size,
                                                       n)))
        feats.append(activations(images, feature_fn, batch_size=batch_size,
                                 mesh=mesh))
    mu, sigma = compute_statistics(np.concatenate(feats))
    return mu, sigma, n


def main(argv=None) -> int:
    from ..data.native_loader import NativeBatchLoader
    from ..eval.inception import default_feature_fn

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", nargs="+", required=True,
                   help="uint8 record files (CIFAR-10 binary layout)")
    p.add_argument("--inception", default=None,
                   help="pt_inception-2015-12-05.pth (random weights if "
                        "omitted: the pipeline only)")
    p.add_argument("--out", default="cifar10_mu_sigma.npz")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--label-bytes", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..parallel import make_mesh
    mesh = make_mesh(device=args.device)
    feature_fn = default_feature_fn(args.inception, device=args.device)
    loader = NativeBatchLoader(args.data, label_bytes=args.label_bytes)
    print(f"dataset: {len(loader)} records ({loader.backend} backend)")
    if not args.inception:
        print("WARNING: no inception weights -- the statistics are NOT "
              "pytorch-fid's (pipeline only)")

    mu, sigma, n = compute_dataset_stats(loader, feature_fn,
                                         batch_size=args.batch,
                                         limit=args.limit,
                                         mesh=mesh if mesh.size() > 1
                                         else None)
    prov = "converted" if args.inception else "random"
    np.savez(args.out, mu=mu, sigma=sigma, weights=np.asarray(prov))
    print(f"{args.out}: mu{mu.shape} sigma{sigma.shape} over {n} images "
          f"(inception weights={prov})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
