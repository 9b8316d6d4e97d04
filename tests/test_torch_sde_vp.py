"""The port's VP and sub-VP SDEs, score wrappers, the rest of the
predictor-corrector steps, RK45 and the ODE sampler against the JAX
package's (``sde.py``, ``samplers/pc.py``, ``samplers/rk45.py``) on the
CPU, and the ten VP / sub-VP configs field by field.  Steps are fed the
noise JAX draws from the same keys; the analytic cases of
``tests/test_pc_samplers.py`` run through both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu import sde as jsde
from naturaldiffusion_tpu.configs import get_config as jax_get_config
from naturaldiffusion_tpu.samplers import pc as jpc
from naturaldiffusion_tpu.samplers.rk45 import rk45_integrate as j_rk45
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch import sde as psde
from naturaldiffusion_tpu_torch.samplers import pc
from naturaldiffusion_tpu_torch.samplers.rk45 import rk45_integrate

torch.set_num_threads(2)

SHAPE = (4, 4, 4, 1)
# one step in f32 against JAX's step in f32 on the same inputs and noise:
# a handful of f32 roundings
STEP_RTOL = 1e-5
# float64 on both sides (JAX under x64, as its own tests run): sums of a
# few float64 roundings
F64_RTOL = 1e-8

VP_CONFIGS = ["vp/cifar10_ddpmpp", "vp/cifar10_ncsnpp",
              "vp/cifar10_ddpmpp_continuous", "vp/cifar10_ncsnpp_continuous",
              "vp/cifar10_ddpmpp_deep_continuous",
              "vp/cifar10_ncsnpp_deep_continuous",
              "subvp/cifar10_ddpmpp_continuous",
              "subvp/cifar10_ncsnpp_continuous",
              "subvp/cifar10_ddpmpp_deep_continuous",
              "subvp/cifar10_ncsnpp_deep_continuous"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(kind, **kw):
    return getattr(jsde, kind)(**kw), getattr(psde, kind)(**kw)


def _delta_score(sde_, xp):
    """-x / std^2 with the SDE's own marginal std: the exact score of data
    = delta(0) under VP and VE."""
    def score(x, t):
        std = sde_.marginal_prob(xp.zeros_like(x), t)[1]
        return -x / std.reshape(-1, 1, 1, 1) ** 2
    return score


@pytest.mark.parametrize("kind", ["VPSDE", "SubVPSDE", "VESDE"])
def test_sde_methods_match_jax(kind):
    j, p = _pair(kind, N=50)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([1.0, 0.5, 0.0123, 1e-3], np.float32)
    jx, jt, px, pt = jnp.asarray(x), jnp.asarray(t), _t(x), _t(t)
    # VP's discretize subtracts x from sqrt(1 - beta) x (JAX in float64
    # here, the port in float32): absolute to 1e-6, a rounding of |x| ~ 2
    for name in ("sde", "marginal_prob", "discretize"):
        for a, b in zip(getattr(p, name)(px, pt), getattr(j, name)(jx, jt)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=STEP_RTOL, atol=1e-6)
    np.testing.assert_allclose(p.prior_logp(px).numpy(),
                               np.asarray(j.prior_logp(jx)), rtol=STEP_RTOL)
    prior = p.prior_sampling((2, 3), torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    assert prior.shape == (2, 3) and torch.isfinite(prior).all()


@pytest.mark.parametrize("kind,continuous", [("VPSDE", True),
                                             ("VPSDE", False),
                                             ("SubVPSDE", True),
                                             ("SubVPSDE", False)])
def test_vp_score_fn_matches_jax(kind, continuous):
    """The label each convention gives the model and the score it makes of
    the model's eps: continuous ``t * 999`` and ``-eps / std``; discrete
    ``t (N - 1)`` and the DDPM table's ``sqrt(1 - abar)``."""
    j, p = _pair(kind, N=1000)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([1.0, 0.5, 0.0123, 1e-3], np.float32)
    seen = {}

    def model(xp_name):
        def apply(xx, lab):
            seen[xp_name] = np.asarray(lab)
            return xx * 0.5 + 0.1
        return apply

    got = psde.get_score_fn(p, model("p"), continuous=continuous)(
        _t(x), _t(t)).numpy()
    want = np.asarray(jsde.get_score_fn(j, model("j"), continuous=continuous)(
        jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(seen["p"], seen["j"], rtol=STEP_RTOL)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)


def _jax_noise(key, shape):
    with jax.enable_x64(False):     # float32 noise, as the samplers draw it
        return np.asarray(jax.random.normal(key, shape))


@pytest.mark.parametrize("name,kind", [("euler_maruyama", "VPSDE"),
                                       ("euler_maruyama", "SubVPSDE"),
                                       ("euler_maruyama", "VESDE"),
                                       ("ancestral_sampling", "VPSDE"),
                                       ("ancestral_sampling", "VESDE"),
                                       ("reverse_diffusion", "VPSDE")])
def test_predictor_step_matches_jax_with_its_noise(name, kind):
    j, p = _pair(kind, N=50)
    x = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    t = np.full((SHAPE[0],), 0.7, np.float32)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        want, want_mean = jpc.get_predictor(name)(
            j, _delta_score(j, jnp), jnp.asarray(x), jnp.asarray(t), key)
    z = _jax_noise(key, SHAPE)
    got, got_mean = pc.get_predictor(name)(p, _delta_score(p, torch), _t(x),
                                           _t(t), _t(z))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                               rtol=STEP_RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=1e-6)


@pytest.mark.parametrize("name,kind", [("langevin", "VPSDE"),
                                       ("langevin", "SubVPSDE"),
                                       ("ald", "VPSDE"), ("ald", "VESDE")])
def test_corrector_steps_match_jax_with_its_noise(name, kind):
    """Two steps: alpha from the DDPM discretisation for VP, 1 otherwise."""
    j, p = _pair(kind, N=50)
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    t = np.full((SHAPE[0],), 0.3, np.float32)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        want, _ = jpc.get_corrector(name)(
            j, _delta_score(j, jnp), jnp.asarray(x), jnp.asarray(t), key,
            snr=0.16, n_steps=2)
    noises, k = [], key
    for _ in range(2):              # the key splits of JAX's fori_loop body
        k, sub = jax.random.split(k)
        noises.append(_t(_jax_noise(sub, SHAPE)))
    got, _ = pc.get_corrector(name)(p, _delta_score(p, torch), _t(x), _t(t),
                                    noises, snr=0.16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=1e-6)


def test_registries_and_unknown_names():
    assert {"euler_maruyama", "reverse_diffusion", "ancestral_sampling",
            "none"} <= set(pc._PREDICTORS)
    assert set(pc._CORRECTORS) == {"langevin", "ald", "none"}

    @pc.register_predictor("_probe")
    def probe(sde, score_fn, x, t, z):
        return x, x
    try:
        assert pc.get_predictor("_probe") is probe
    finally:
        del pc._PREDICTORS["_probe"]
    with pytest.raises(KeyError, match="unknown corrector"):
        pc.get_corrector("nope")


@pytest.mark.parametrize("pred,corr", [("euler_maruyama", "none"),
                                       ("ancestral_sampling", "none"),
                                       ("reverse_diffusion", "langevin"),
                                       ("euler_maruyama", "ald")])
def test_vp_pc_sampler_contracts_to_data(pred, corr):
    """VP at N = 200 with data = delta(0) (tests/test_pc_samplers.py:
    52-64): finite, mean |x| below 0.25."""
    sde_ = psde.VPSDE(N=200)
    sampler = pc.get_pc_sampler(sde_, _delta_score(sde_, torch), SHAPE,
                                predictor=pred, corrector=corr, device="cpu")
    x, nfe = sampler(torch.Generator().manual_seed(0))
    assert torch.isfinite(x).all() and nfe == 400
    assert float(x.abs().mean()) < 0.25


@pytest.mark.parametrize("case", ["linear", "reverse"])
def test_rk45_matches_jax_analytic_cases(case):
    """``tests/test_pc_samplers.py:36-49`` in float64 (x64): the same nfe,
    the same result within 1e-8, and the analytic value."""
    if case == "linear":
        y0, t0, t1 = np.full(3, 2.0), 0.0, 1.0
        jf, pf, exact = (lambda y, t: -y), (lambda y, t: -y), 2 * np.exp(-1)
    else:
        y0, t0, t1 = np.ones(2), 1.0, 0.0
        jf, pf, exact = (lambda y, t: y * 0 + t), \
            (lambda y, t: y * 0 + float(t)), 0.5
    calls = []

    def counted(y, t):
        calls.append(t)
        return pf(y, t)

    wy, wn = j_rk45(jf, jnp.asarray(y0), t0, t1, rtol=1e-8, atol=1e-8)
    gy, gn = rk45_integrate(counted, torch.from_numpy(y0), t0, t1,
                            rtol=1e-8, atol=1e-8)
    # the port's calls are its nfe: the last stage is the next first
    assert gn == int(wn) == len(calls) > 6
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=F64_RTOL)
    np.testing.assert_allclose(gy.numpy(), exact, rtol=1e-6)


def test_rk45_float32_ends_where_jax_float32_runs_away():
    """The port keeps the time in float64 host scalars.  JAX keeps it in
    the state's type, and in float32 this integration's last clamped step
    lands one ulp past t1 and walks away from it until ``_MAX_STEPS``
    (nfe 60001).  The port's float32 run takes JAX's float64 steps and
    meets JAX's float64 result to float32 rounding."""
    y0 = np.linspace(-1, 1, 6)
    with jax.enable_x64(False):
        _, n32 = j_rk45(lambda y, t: -2.0 * y * t,
                        jnp.asarray(y0, jnp.float32), 1.0, 1e-3, rtol=1e-5,
                        atol=1e-5)
    wy, wn = j_rk45(lambda y, t: -2.0 * y * t, jnp.asarray(y0), 1.0, 1e-3,
                    rtol=1e-5, atol=1e-5)
    gy, gn = rk45_integrate(lambda y, t: -2.0 * y * t,
                            torch.from_numpy(y0).float(), 1.0, 1e-3,
                            rtol=1e-5, atol=1e-5)
    assert int(n32) == 1 + 6 * 10_000 and gn == int(wn) < 100
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=STEP_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("score,denoise", [("gauss", False),
                                           ("delta", True)])
def test_ode_sampler_matches_jax(score, denoise):
    """The probability-flow ODE from JAX's prior sample: N(0, I) data (the
    drift vanishes: tests/test_pc_samplers.py:82-91) and delta(0) data
    with the denoising step.  Float64 on both sides (x64): the same nfe,
    the result within 1e-8; the port in float32: the same nfe, within
    1e-5 of the float64 result."""
    j, p = jsde.VPSDE(), psde.VPSDE()
    if score == "gauss":
        js, ps = (lambda x, t: -x), (lambda x, t: -x)
    else:
        js, ps = _delta_score(j, jnp), _delta_score(p, torch)
    key = jax.random.PRNGKey(1)
    _, sub = jax.random.split(key)
    x_init = _jax_noise(sub, SHAPE).astype(np.float64)
    kw = dict(rtol=1e-3, atol=1e-3, eps=1e-2, denoise=denoise)
    want, wn = jpc.get_ode_sampler(j, js, SHAPE, **kw)(
        key, x_init=jnp.asarray(x_init))
    want = np.asarray(want)
    got, gn = pc.get_ode_sampler(p, ps, SHAPE, device="cpu", **kw)(
        x_init=torch.from_numpy(x_init))
    assert gn == int(wn)
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_RTOL,
                               atol=F64_RTOL)
    got32, gn32 = pc.get_ode_sampler(p, ps, SHAPE, device="cpu", **kw)(
        x_init=torch.from_numpy(x_init).float())
    assert got32.dtype == torch.float32 and gn32 == gn
    np.testing.assert_allclose(got32.numpy(), want, rtol=STEP_RTOL,
                               atol=1e-6)
    if score == "gauss":
        np.testing.assert_allclose(got.numpy(), x_init, atol=1e-3)


@pytest.mark.parametrize("name", VP_CONFIGS)
def test_vp_configs_match_jax_field_by_field(name):
    mine, ref = configs.get_config(name), jax_get_config(name)
    assert mine.name == ref.name and ref.model_family == "ncsnpp"
    for f in dataclasses.fields(mine.model):
        assert getattr(mine.model, f.name) == getattr(ref.model, f.name), f
    for f in dataclasses.fields(mine.sde):
        assert getattr(mine.sde, f.name) == getattr(ref.training, f.name), f
    assert dataclasses.asdict(mine.sampling) == dataclasses.asdict(
        ref.sampling)
    sde = configs.get_sde(mine)
    assert type(sde).__name__ == {"vpsde": "VPSDE",
                                  "subvpsde": "SubVPSDE"}[ref.training.sde]
    assert (sde.beta_min, sde.beta_max, sde.N) == (
        ref.training.beta_min, ref.training.beta_max,
        ref.training.num_scales)
