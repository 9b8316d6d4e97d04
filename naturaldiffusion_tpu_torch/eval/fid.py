"""FID and Inception Score (port of ``naturaldiffusion_tpu/eval/fid.py``;
the reference: ``src/CIFAR10NaturalInference.py:44-86`` on pytorch-fid).

* :func:`frechet_distance`: the Frechet distance between two Gaussians,
  float64 ``scipy.linalg.sqrtm`` on the host, the code path of pytorch-fid's
  ``calculate_frechet_distance`` (its eps-offset retry and imaginary-part
  check).  scipy is the one package beside torch and numpy that the port
  imports, here only.
* :func:`compute_statistics`: (mu, sigma) of a feature matrix, float64.
* :func:`activations`: batched features through a feature fn, e.g.
  :func:`.inception.default_feature_fn`, which takes ``[n, H, W, 3]`` in
  [0, 1] and returns a tensor ``[n, D]``.
* :func:`inception_score` and :func:`fid_from_samples`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def compute_statistics(feats) -> tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """pytorch-fid ``calculate_frechet_distance``, the same float64 steps.
    Raises ``ValueError`` when ``sqrtm`` leaves an imaginary diagonal
    beyond 1e-3."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


@torch.no_grad()
def activations(images, feature_fn: Callable, batch_size: int = 256,
                mesh=None, pad_to_batch: bool = False,
                data_axis: str = "data") -> np.ndarray:
    """``[N, H, W, C]`` in [0, 1] (a numpy array or a tensor on any
    device) -> ``[N, D]`` float32 numpy features, ``batch_size`` images a
    call of ``feature_fn``.

    ``mesh`` (JAX ``eval/fid.py:52-70``, the reference's
    ``run_inception_distributed``): every rank passes the same images; the
    batch size is rounded to a multiple of the ``data`` axis's ranks, each
    chunk is edge-padded to such a multiple, each rank takes its own rows
    through ``feature_fn``, and the features are all-gathered over the
    axis.

    ``pad_to_batch``: repeat the last image to fill the tail chunk up to a
    full ``batch_size``, so that every call has one shape (the features of
    the padding are dropped)."""
    images = torch.as_tensor(images)
    ndev = 1
    if mesh is not None:
        from ..parallel.mesh import axis_size
        ndev = axis_size(mesh, data_axis)
        batch_size = max(batch_size // ndev * ndev, ndev)
    if pad_to_batch:
        n = len(images)
        tail = n % batch_size
        if tail:
            last = torch.cat([images[n - tail:], images[-1:].expand(
                (batch_size - tail,) + tuple(images.shape[1:]))])
            last = activations(last, feature_fn, batch_size,
                               mesh, data_axis=data_axis)[:tail]
            if n == tail:       # the whole input is smaller than one batch
                return last
            head = activations(images[:n - tail], feature_fn, batch_size,
                               mesh, data_axis=data_axis)
            return np.concatenate([head, last])
    if mesh is None:
        return np.concatenate([
            feature_fn(images[i:i + batch_size]).float().cpu().numpy()
            for i in range(0, len(images), batch_size)])
    out = []
    for i in range(0, len(images), batch_size):
        chunk = images[i:i + batch_size]
        n = len(chunk)
        pad = -n % ndev             # edge-repeat up to a multiple
        if pad:
            chunk = torch.cat([chunk, chunk[-1:].expand(
                (pad,) + tuple(chunk.shape[1:]))])
        out.append(_gathered_features(chunk, feature_fn, mesh,
                                      data_axis)[:n])
    return np.concatenate(out)


def _gathered_features(chunk, feature_fn, mesh, axis: str) -> np.ndarray:
    """This rank's rows of ``chunk`` through ``feature_fn``, all-gathered
    over ``axis`` in rank order."""
    import torch.distributed as dist
    from ..parallel.mesh import axis_index, axis_size
    n = axis_size(mesh, axis)
    feats = feature_fn(chunk.chunk(n)[axis_index(mesh, axis)]).float()
    if n > 1:
        parts = [torch.empty_like(feats) for _ in range(n)]
        dist.all_gather(parts, feats.contiguous(),
                        group=mesh.get_group(axis))
        feats = torch.cat(parts)
    return feats.cpu().numpy()


def inception_score(probs, splits: int = 10) -> tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` parts; (mean, std)
    (the reference reports it beside FID, ``deps/score_sde_pytorch/
    run_lib.py:175-407``)."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-16) - np.log(py + 1e-16)),
                    axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def fid_from_samples(images, stats_path: str,
                     feature_fn: Callable | None = None,
                     value_range=(-1.0, 1.0), device="cuda") -> float:
    """FID of ``images`` ``[N, H, W, C]`` in ``value_range`` against the
    reference statistics in ``stats_path`` (``mu``/``sigma``, or
    ``mu_sigma``: the ``cifar10_mu_sigma.npz`` layout).  Without
    ``feature_fn`` the random-weight Inception of
    :func:`.inception.default_feature_fn` runs on ``device``."""
    with np.load(stats_path) as f:
        mu_ref = f["mu"] if "mu" in f else f["mu_sigma"][0]
        sig_ref = f["sigma"] if "sigma" in f else f["mu_sigma"][1]

    if feature_fn is None:
        from .inception import default_feature_fn
        feature_fn = default_feature_fn(device=device)

    lo, hi = value_range
    imgs = torch.as_tensor(images, dtype=torch.float32)
    imgs01 = ((imgs - lo) / (hi - lo)).clamp(0, 1)
    feats = activations(imgs01, feature_fn)
    mu, sigma = compute_statistics(feats)
    return frechet_distance(mu, sigma, mu_ref, sig_ref)
