"""The port's VESDE, score wrapper and predictor-corrector steps against the
JAX package's (``sde.py``, ``samplers/pc.py``), on the CPU: the steps are
fed the noise that JAX's functions draw from the same keys; the whole
sampler is held to the statistical bounds of ``tests/test_pc_samplers.py``
with the analytic VE score."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu import sde as jsde
from naturaldiffusion_tpu.data.datasets import (get_inverse_scaler as
                                                jax_inverse_scaler)
from naturaldiffusion_tpu.samplers import pc as jpc
from naturaldiffusion_tpu_torch import scaler
from naturaldiffusion_tpu_torch.samplers import pc
from naturaldiffusion_tpu_torch.sde import VESDE, get_score_fn
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

SHAPE = (4, 4, 4, 1)
# one step in f32 against JAX's step in f32 on the same inputs and noise:
# a handful of f32 roundings of O(sigma) values
STEP_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _score(sde_, xp):
    """The exact score of data = delta(0) under a VE SDE: -x / sigma_t^2."""
    def score(x, t):
        std = sde_.marginal_prob(xp.zeros_like(x), t)[1]
        return -x / std.reshape(-1, 1, 1, 1) ** 2
    return score


@pytest.mark.parametrize("continuous", [True, False])
def test_vesde_and_score_fn_match_jax(continuous):
    j, p = jsde.VESDE(sigma_max=348.0, N=2000), VESDE(sigma_max=348.0, N=2000)
    t = np.array([1.0, 0.5, 0.0123, 1e-3], np.float32)
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    jt, pt = jnp.asarray(t), _t(t)
    np.testing.assert_allclose(p.sigma(pt).numpy(), np.asarray(j.sigma(jt)),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(p.sde(_t(x), pt)[1].numpy(),
                               np.asarray(j.sde(jnp.asarray(x), jt)[1]),
                               rtol=STEP_RTOL)
    for a, b in zip(p.discretize(_t(x), pt),
                    j.discretize(jnp.asarray(x), jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=STEP_RTOL, atol=1e-7)
    labels_p = get_score_fn(p, lambda xx, lab: lab, continuous=continuous)
    labels_j = jsde.get_score_fn(j, lambda xx, lab: lab,
                                 continuous=continuous)
    np.testing.assert_allclose(labels_p(_t(x), pt).numpy(),
                               np.asarray(labels_j(jnp.asarray(x), jt)),
                               rtol=STEP_RTOL)


def test_reverse_diffusion_step_matches_jax_with_its_noise():
    j, p = jsde.VESDE(N=50), VESDE(N=50)
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    t = np.full((SHAPE[0],), 0.7, np.float32)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):     # float32 noise, as the sampler draws it
        want, want_mean = jpc.reverse_diffusion(
            j, _score(j, jnp), jnp.asarray(x), jnp.asarray(t), key)
        z = np.asarray(jax.random.normal(key, SHAPE))
    got, got_mean = pc.reverse_diffusion(p, _score(p, torch), _t(x), _t(t),
                                         _t(z))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                               rtol=STEP_RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=1e-5)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_langevin_step_matches_jax_with_its_noise(n_steps):
    j, p = jsde.VESDE(N=50), VESDE(N=50)
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    t = np.full((SHAPE[0],), 0.3, np.float32)
    key = jax.random.PRNGKey(4)
    noises, k = [], key
    with jax.enable_x64(False):     # float32 noise, as the sampler draws it
        want, _ = jpc.langevin(j, _score(j, jnp), jnp.asarray(x),
                               jnp.asarray(t), key, snr=0.075,
                               n_steps=n_steps)
        for _ in range(n_steps):    # the key splits of JAX's fori_loop body
            k, sub = jax.random.split(k)
            noises.append(_t(jax.random.normal(sub, SHAPE)))
    got, _ = pc.langevin(p, _score(p, torch), _t(x), _t(t), noises,
                         snr=0.075)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=1e-6)


@pytest.mark.parametrize("pred,corr", [("reverse_diffusion", "none"),
                                       ("reverse_diffusion", "langevin"),
                                       ("none", "langevin")])
def test_pc_sampler_contracts_to_data(pred, corr):
    """VE at N = 200 with data = delta(0) (tests/test_pc_samplers.py:67-79
    and :82-93): finite, and the samples' mean |x| below 0.2 after starting
    at sigma_max = 50."""
    sde_ = VESDE(N=200)
    sampler = pc.get_pc_sampler(sde_, _score(sde_, torch), SHAPE,
                                predictor=pred, corrector=corr,
                                device="cpu")
    x, nfe = sampler(torch.Generator().manual_seed(0))
    assert x.shape == SHAPE and torch.isfinite(x).all()
    assert nfe == 200 * 2
    if pred != "none":
        assert float(x.abs().mean()) < 0.2


def test_pc_sampler_draws_from_its_generator_and_rejects_unported():
    sde_ = VESDE(N=5)
    sampler = pc.get_pc_sampler(sde_, _score(sde_, torch), SHAPE,
                                corrector="langevin", snr=0.075,
                                device="cpu")
    a, _ = sampler(torch.Generator().manual_seed(7))
    b, _ = sampler(torch.Generator().manual_seed(7))
    c, _ = sampler(torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # every predictor and corrector of the JAX package is ported; a name
    # neither package registers raises
    for kw in (dict(predictor="euler_maruyama"), dict(corrector="ald")):
        pc.get_pc_sampler(sde_, None, SHAPE, device="cpu", **kw)
    with pytest.raises(KeyError, match="unknown predictor"):
        pc.get_pc_sampler(sde_, None, SHAPE, predictor="nope", device="cpu")


@pytest.mark.parametrize("centered", [True, False])
def test_inverse_scaler_matches_jax(centered):
    x = np.linspace(-1, 1, 7, dtype=np.float32)
    np.testing.assert_allclose(
        scaler.get_inverse_scaler(centered)(_t(x)).numpy(),
        np.asarray(jax_inverse_scaler(centered)(jnp.asarray(x))))
