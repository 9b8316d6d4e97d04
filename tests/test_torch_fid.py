"""The port's FID and IS (``naturaldiffusion_tpu_torch/eval/fid.py``)
against the JAX package's ``eval/fid.py`` on the same numpy inputs:
``frechet_distance`` (its eps-offset retry and its imaginary-part check
too), ``compute_statistics``, ``inception_score`` and ``fid_from_samples``
to 1e-10 relative, and ``activations``' batching and tail padding."""

import numpy as np
import pytest
import scipy.linalg
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
from naturaldiffusion_tpu.eval import fid as jfid
from naturaldiffusion_tpu_torch.eval import fid as pfid

# float64 on both sides through the same numpy and scipy calls
REL = 1e-10


def _stats(seed, d=12, n=64):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)) @ rng.standard_normal((d, d))
    return f.mean(0) + rng.standard_normal(d) * 0.1, np.cov(f, rowvar=False)


def test_frechet_distance_matches_jax():
    (m1, s1), (m2, s2) = _stats(0), _stats(1)
    want = jfid.frechet_distance(m1, s1, m2, s2)
    got = pfid.frechet_distance(m1, s1, m2, s2)
    assert want > 1.0
    assert abs(got - want) <= REL * abs(want)
    assert abs(pfid.frechet_distance(m1, s1, m1, s1)) < 1e-8


def test_frechet_distance_eps_retry_matches_jax(monkeypatch):
    """A first ``sqrtm`` that is not finite: both retry with ``eps`` added
    to the diagonals and return the same distance."""
    (m1, s1), (m2, s2) = _stats(2), _stats(3)
    real = scipy.linalg.sqrtm
    calls = []

    def first_nan(a, *args, **kw):
        calls.append(a)
        if len(calls) % 2 == 1:
            return np.full_like(a, np.nan)
        return real(a, *args, **kw)

    monkeypatch.setattr(scipy.linalg, "sqrtm", first_nan)
    want = jfid.frechet_distance(m1, s1, m2, s2, eps=1e-3)
    got = pfid.frechet_distance(m1, s1, m2, s2, eps=1e-3)
    assert len(calls) == 4
    np.testing.assert_array_equal(calls[1], calls[3])   # the offset product
    off = np.eye(len(m1)) * 1e-3
    np.testing.assert_allclose(calls[3], (s1 + off) @ (s2 + off), rtol=1e-14)
    assert abs(got - want) <= REL * abs(want)


@pytest.mark.parametrize("imag", [1e-5, 1e-1])
def test_frechet_distance_imaginary_part_matches_jax(monkeypatch, imag):
    """A complex ``sqrtm``: an imaginary diagonal within 1e-3 is dropped,
    a larger one raises, in both packages."""
    (m1, s1), (m2, s2) = _stats(4), _stats(5)
    real = scipy.linalg.sqrtm
    monkeypatch.setattr(scipy.linalg, "sqrtm", lambda a, *args, **kw: (
        real(a, *args, **kw) + 1j * imag * np.eye(len(a))))
    if imag > 1e-3:
        for f in (jfid.frechet_distance, pfid.frechet_distance):
            with pytest.raises(ValueError, match="Imaginary component"):
                f(m1, s1, m2, s2)
        return
    want = jfid.frechet_distance(m1, s1, m2, s2)
    assert abs(pfid.frechet_distance(m1, s1, m2, s2) - want) <= \
        REL * abs(want)


def test_compute_statistics_and_inception_score_match_jax():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((50, 9)).astype(np.float32)
    for a, b in zip(pfid.compute_statistics(feats),
                    jfid.compute_statistics(feats)):
        np.testing.assert_allclose(a, b, rtol=REL, atol=0)
    logits = rng.standard_normal((103, 17)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (10, 3):
        got = pfid.inception_score(probs, splits)
        want = jfid.inception_score(probs, splits)
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert got[0] > 1.0


def _np_feat(x):
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    return np.stack([x.mean(1), x.std(1), x.max(1)], axis=1)


@pytest.mark.parametrize("n,batch,pad", [(10, 4, True), (10, 4, False),
                                         (3, 4, True), (8, 4, True)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_activations_batches_and_pads_as_jax(n, batch, pad, as_tensor):
    images = np.random.default_rng(n).uniform(0, 1, (n, 4, 4, 3)).astype(
        np.float32)
    seen = []

    def feat(x):
        assert isinstance(x, torch.Tensor)
        seen.append(len(x))
        return torch.from_numpy(_np_feat(x.numpy())).float()

    want = jfid.activations(images, _np_feat, batch_size=batch,
                            pad_to_batch=pad)
    got = pfid.activations(torch.from_numpy(images) if as_tensor else images,
                           feat, batch_size=batch, pad_to_batch=pad)
    assert got.shape == (n, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)
    if pad:     # every call is a full batch, the tail padded by its last
        assert set(seen) == {batch}
    else:
        assert seen == [min(batch, n - i) for i in range(0, n, batch)]


def test_fid_from_samples_matches_jax(tmp_path):
    """Images in [-1, 1] against a ``{mu, sigma}`` npz, one feature fn on
    both sides (float32 features, as the Inception's)."""
    rng = np.random.default_rng(8)
    ref = rng.uniform(-1, 1, (40, 8, 8, 3)).astype(np.float32)
    mu, sigma = jfid.compute_statistics(
        _np_feat((ref + 1) / 2).astype(np.float32))
    path = str(tmp_path / "stats.npz")
    np.savez(path, mu=mu, sigma=sigma)
    imgs = np.clip(ref * 0.8 + 0.1, -1.2, 1.2)

    def feat(x):
        return torch.from_numpy(_np_feat(x.numpy())).float()

    want = jfid.fid_from_samples(imgs, path, feature_fn=lambda x: _np_feat(
        np.asarray(x)).astype(np.float32))
    got = pfid.fid_from_samples(imgs, path, feature_fn=feat)
    assert want > 1e-4
    assert abs(got - want) <= REL * abs(want)
    assert abs(pfid.fid_from_samples(ref, path, feature_fn=feat)) < 1e-8
