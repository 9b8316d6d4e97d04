"""Procedural "gradient + ellipse" distribution in CIFAR-10 binary layout
(port of ``naturaldiffusion_tpu/apps/toy_dataset.py``; numpy only, the same
bytes from the same seed).

The reference's real-data loop (train, snapshot, sample, score with FID)
needs ``checkpoint_8.pth`` and the CIFAR-10 release, neither of which is in
the repository.  This writer makes a *known* distribution with the same
tensor interface (32x32x3 uint8 in CIFAR-10 binary records, read by
``data/datasets.py:cifar10_iterator``), so the training pipeline can be run
end to end with checkable ground truth.

Every image is a vertical two-color linear gradient plus one antialiased
solid ellipse.  All parameters are uniform and independent by
construction, and each is recoverable from pixels (``summary_stats``):

* gradient endpoints ``c0``/``c1`` -> per-image top/bottom row means;
* ``grad_delta = mean(c1 - c0)`` -> bottom-minus-top mean difference;
* ellipse coverage -> fraction of pixels deviating from the per-row
  background estimate (the row *median*: the ellipse spans at most
  ``2*R_MAX = 14 < 16`` pixels of any row, so the median is always
  background).

One vectorized draw produces the whole parameter table, so the
train/eval split is an index range of a single deterministic stream.

Usage::

    python -m naturaldiffusion_tpu_torch.apps.toy_dataset --out /tmp/toy_cifar
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

SEED = 20260819
SIZE = 32
C_MAX = 23.0           # ellipse centers stay >= R_MAX from the border
C_MIN = 9.0
R_MIN, R_MAX = 3.0, 7.0


def draw_params(n_total: int, seed: int = SEED) -> dict[str, np.ndarray]:
    """The whole parameter table in one deterministic vectorized draw."""
    rng = np.random.default_rng(seed)
    return {
        "c0": rng.uniform(0.0, 255.0, (n_total, 3)),
        "c1": rng.uniform(0.0, 255.0, (n_total, 3)),
        "center": rng.uniform(C_MIN, C_MAX, (n_total, 2)),     # (cx, cy)
        "radii": rng.uniform(R_MIN, R_MAX, (n_total, 2)),      # (rx, ry)
        "col": rng.uniform(0.0, 255.0, (n_total, 3)),
    }


def render(params: dict[str, np.ndarray], lo: int, hi: int) -> np.ndarray:
    """Rows ``lo:hi`` of the parameter table -> [hi-lo, 32, 32, 3] uint8."""
    c0 = params["c0"][lo:hi]
    c1 = params["c1"][lo:hi]
    cx, cy = params["center"][lo:hi, 0], params["center"][lo:hi, 1]
    rx, ry = params["radii"][lo:hi, 0], params["radii"][lo:hi, 1]
    col = params["col"][lo:hi]
    n = hi - lo

    y = np.arange(SIZE, dtype=np.float32)
    frac = (y / (SIZE - 1))[None, :, None]                     # [1, 32, 1]
    bg = c0[:, None, :] + (c1 - c0)[:, None, :] * frac         # [N, 32, 3]
    img = np.broadcast_to(bg[:, :, None, :],
                          (n, SIZE, SIZE, 3)).astype(np.float32).copy()

    xs = np.arange(SIZE, dtype=np.float32)
    # squared normalized distance to the ellipse boundary, [N, 32y, 32x]
    d = (((xs[None, None, :] - cx[:, None, None]) / rx[:, None, None]) ** 2
         + ((y[None, :, None] - cy[:, None, None]) / ry[:, None, None]) ** 2)
    # ~1px-wide soft edge in pixel units: |grad d| ~ 2/r at the boundary
    edge = 2.0 / np.minimum(rx, ry)[:, None, None]
    alpha = np.clip((1.0 - d) / edge + 0.5, 0.0, 1.0)[..., None]
    img = img * (1.0 - alpha) + col[:, None, None, :] * alpha
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_cifar_bin(images: np.ndarray, path: str,
                    labels: np.ndarray | None = None) -> None:
    """CIFAR-10 binary records: 1 label byte + 3072 planar R,G,B bytes."""
    n = len(images)
    if labels is None:
        labels = np.zeros(n, np.uint8)
    planar = images.transpose(0, 3, 1, 2).reshape(n, 3 * SIZE * SIZE)
    rec = np.concatenate([labels.astype(np.uint8)[:, None], planar], axis=1)
    rec.tofile(path)


def summary_stats(images01: np.ndarray) -> dict[str, np.ndarray]:
    """Per-image scalar summaries (inputs in [0, 1], [N, 32, 32, 3]).

    Each is a clean function of the generator's uniform parameters, so the
    *distribution* of each summary is ground truth the trained model's
    samples must reproduce (compared by W1, ``wasserstein1``).
    """
    x = np.asarray(images01, np.float32)
    top = x[:, :3].mean(axis=(1, 2, 3))
    bottom = x[:, -3:].mean(axis=(1, 2, 3))
    # per-row background = row median over x (ellipse < half of any row)
    row_bg = np.median(x, axis=2)                              # [N, 32, 3]
    resid = np.abs(x - row_bg[:, :, None, :]).mean(axis=3)     # [N, 32, 32]
    return {
        "img_mean": x.mean(axis=(1, 2, 3)),
        "grad_delta": bottom - top,
        "ellipse_frac": (resid > 0.08).mean(axis=(1, 2)),
    }


def wasserstein1(a: np.ndarray, b: np.ndarray) -> float:
    """W1 between two empirical 1-D distributions (equal-quantile form)."""
    n = min(len(a), len(b))
    qa = np.quantile(np.asarray(a, np.float64), np.linspace(0, 1, n))
    qb = np.quantile(np.asarray(b, np.float64), np.linspace(0, 1, n))
    return float(np.abs(qa - qb).mean())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=50_000)
    p.add_argument("--n-eval", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--chunk", type=int, default=5_000)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    total = args.n_train + args.n_eval
    params = draw_params(total, args.seed)

    per_file = 10_000 if args.n_train % 10_000 == 0 else args.n_train
    splits = [(f"data_batch_{i + 1}.bin", s, min(s + per_file, args.n_train))
              for i, s in enumerate(range(0, args.n_train, per_file))]
    splits.append(("test_batch.bin", args.n_train, total))

    for name, lo, hi in splits:
        chunks = [render(params, c, min(c + args.chunk, hi))
                  for c in range(lo, hi, args.chunk)]
        write_cifar_bin(np.concatenate(chunks), os.path.join(args.out, name))
        print(f"{name}: {hi - lo} records")
    print(f"-> {args.out} (seed {args.seed}, "
          f"{args.n_train} train / {args.n_eval} eval)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
