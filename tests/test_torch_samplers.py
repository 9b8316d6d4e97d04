"""The port's direct samplers, DPM-Solver and DEIS against the JAX
package's (``samplers/direct.py``, ``samplers/dpm_solver.py``,
``samplers/deis.py``) on the same numpy inputs, and the port's Natural
Inference against its direct recursions, as ``apps/validate.py``,
``tests/test_dpm_solver.py:116`` and ``tests/test_deis_samplers.py:42``
run them.  Float64 on both sides where JAX's own tests run with x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.apps import validate as jvalidate
from naturaldiffusion_tpu.samplers import deis as jdeis
from naturaldiffusion_tpu.samplers import direct as jdirect
from naturaldiffusion_tpu.samplers import dpm_solver as jdpm
from naturaldiffusion_tpu.schedules import LinearVPSDE as JLinearVPSDE
from naturaldiffusion_tpu_torch.apps import validate
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.engine import NISchedule, natural_inference
from naturaldiffusion_tpu_torch.samplers import deis, direct
from naturaldiffusion_tpu_torch.samplers import dpm_solver as pdpm
from naturaldiffusion_tpu_torch.schedules import LinearVPSDE

torch.set_num_threads(2)

SHAPE = (2, 8)
# float64 on both sides: the same float64 recursions, summed in another
# order at most
F64_TOL = 1e-8
# float32 on both sides: a few f32 roundings a step, relative
F32_RTOL = 1e-5
# NI against the direct recursion, both in float64 on the CPU: the
# validate app's own tolerance
NI_TOL = 1e-4


@pytest.fixture(scope="module")
def init():
    return np.random.default_rng(0).standard_normal(SHAPE)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- direct samplers ----------------------------------------------------------


@pytest.mark.parametrize("alg", sorted(validate._DIRECT))
def test_direct_sampler_and_ni_match(alg):
    """Each direct recursion against JAX's on the same init and noises
    (float64), and the port's NI with the derived matrix against it, the
    validate app's check."""
    n = 8
    rng = np.random.default_rng(1)
    init = rng.standard_normal((2, 4, 4, 3))
    noises = rng.standard_normal((n, 2, 4, 4, 3))
    stochastic = validate._DIRECT[alg][1]
    jx0 = jvalidate.toy_x0_tfree if alg == "ode_heun" else jvalidate.toy_x0
    jfn = getattr(jdirect, "ddpm_ancestral" if alg == "ddpm" else alg)
    args = (jnp.asarray(noises),) if stochastic else ()
    want = np.asarray(jfn(jx0, n, jnp.asarray(init), *args,
                          dtype=jnp.float64))
    got, ni = validate.run_pair(alg, n, torch.from_numpy(init),
                                torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), want, rtol=F64_TOL, atol=F64_TOL)
    assert float((ni - got).abs().max()) < F64_TOL
    assert validate.validate(alg, 6, device="cpu") < NI_TOL


def test_direct_sampler_float32_matches_jax():
    n = 6
    init = np.random.default_rng(2).standard_normal((2, 4, 4, 3)).astype(
        np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jdirect.ddim(jvalidate.toy_x0, n,
                                       jnp.asarray(init)))
    got = direct.ddim(validate.toy_x0, n, torch.from_numpy(init))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=1e-6)


# -- DPM-Solver ---------------------------------------------------------------


def _jeps(ns):
    def eps(x, t):
        a, s = ns.marginal_alpha(t), ns.marginal_std(t)
        return (x - a.reshape(-1, 1) * jnp.tanh(x) * 0.5) / s.reshape(-1, 1)
    return eps


def _peps(ns):
    def eps(x, t):
        a, s = ns.marginal_alpha(t), ns.marginal_std(t)
        return (x - a.reshape(-1, 1) * torch.tanh(x) * 0.5) / s.reshape(-1, 1)
    return eps


def _solvers(alg, schedule="linear", **kw):
    if schedule == "discrete":
        betas = np.linspace(0.1 / 1000, 20.0 / 1000, 1000)
        nj = jdpm.NoiseScheduleVP.discrete(betas=betas)
        np_ = pdpm.NoiseScheduleVP.discrete(betas=betas)
    else:
        nj = jdpm.NoiseScheduleVP(schedule=schedule)
        np_ = pdpm.NoiseScheduleVP(schedule=schedule)
    return (jdpm.DPMSolver(jdpm.model_wrapper(_jeps(nj), nj), nj,
                           algorithm_type=alg, **kw),
            pdpm.DPMSolver(pdpm.model_wrapper(_peps(np_), np_), np_,
                           algorithm_type=alg, **kw))


@pytest.mark.parametrize("solver_type", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("method", ["multistep", "singlestep",
                                    "singlestep_fixed"])
@pytest.mark.parametrize("alg", ["dpmsolver", "dpmsolver++"])
def test_dpm_solver_every_method_matches_jax(alg, method, solver_type, init):
    """Orders 1-3 of each method, both algorithm types and solver types,
    float64; the order-3 singlestep plan with 7 steps mixes orders."""
    sj, sp = _solvers(alg)
    for order in (1, 2, 3):
        kw = dict(steps=7, order=order, method=method, t_end=1e-3,
                  solver_type=solver_type)
        want = np.asarray(sj.sample(jnp.asarray(init), **kw))
        got = sp.sample(torch.from_numpy(init), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("schedule,skip", [("cosine", "logSNR"),
                                           ("discrete", "time_quadratic"),
                                           ("linear", "logSNR")])
def test_dpm_solver_schedules_and_grids_match_jax(schedule, skip, init):
    """The cosine and discrete schedules, the logSNR and quadratic grids,
    denoise_to_zero and lower_order_final off."""
    sj, sp = _solvers("dpmsolver++", schedule)
    kw = dict(steps=12, order=3, method="multistep", skip_type=skip,
              lower_order_final=False, denoise_to_zero=True)
    want = np.asarray(sj.sample(jnp.asarray(init), **kw))
    got = sp.sample(torch.from_numpy(init), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    lam = np.linspace(-5.0, 5.0, 7)
    for f in ("inverse_lambda", "marginal_lambda"):
        arg = lam if f == "inverse_lambda" else np.linspace(0.05, 0.9, 7)
        np.testing.assert_allclose(
            getattr(sp.ns, f)(torch.from_numpy(arg)).numpy(),
            np.asarray(getattr(sj.ns, f)(jnp.asarray(arg))), rtol=F64_TOL)


@pytest.mark.parametrize("alg,name,order", [
    ("dpmsolver", "dpmsolver2s", 2),
    ("dpmsolver++", "dpmsolverpp2s", 2),
    ("dpmsolver", "dpmsolver3s", 3)])
def test_dpm_singlestep_equals_ni(alg, name, order, init):
    """tests/test_dpm_solver.py:116: the singlestep update over the
    deriver's grid against the port's NI with the derived matrix."""
    _, sp = _solvers(alg)
    step = 6
    ts = np.linspace(1.0, 0.001, step + 1)
    x = torch.from_numpy(init)
    for i in range(step):
        if order == 2:
            x, _ = sp.second_update(x, ts[i], ts[i + 1], r1=0.5)
        else:
            x, _ = sp.third_update(x, ts[i], ts[i + 1], r1=1 / 3, r2=2 / 3)
    sched = NISchedule.from_matrix(registry.derive(name, step), device="cpu",
                                   dtype=torch.float64)
    ni = natural_inference(lambda z, t: torch.tanh(z) * 0.5, sched,
                           torch.from_numpy(init), prediction_type="x0",
                           accum_dtype=torch.float64)
    np.testing.assert_allclose(x.numpy(), ni.numpy(), atol=F64_TOL)


@pytest.mark.parametrize("alg,order", [("dpmsolver", 2), ("dpmsolver++", 3)])
def test_dpm_adaptive_matches_jax(alg, order, init):
    """The adaptive solver in float32, as JAX runs it.  Its step control
    reads float32 errors computed by XLA on one side and by torch on the
    other, and a last-bit difference can accept or reject a step near
    err = 1, so the two meet within the solver's own rtol (1e-4), not
    to rounding; both meet a tightly resolved multistep solution within
    JAX's own limit (tests/test_dpm_solver.py:210, 1e-2)."""
    sj, sp = _solvers(alg)
    x32 = init.astype(np.float32)
    kw = dict(method="adaptive", order=order, t_end=1e-3, atol=1e-4,
              rtol=1e-4)
    with jax.enable_x64(False):
        want = np.asarray(sj.sample(jnp.asarray(x32), **kw))
    got = sp.sample(torch.from_numpy(x32), **kw).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    ref = sp.sample(torch.from_numpy(init), steps=120, order=3,
                    method="multistep", t_end=1e-3).numpy()
    assert np.abs(got - ref).max() < 1e-2


def test_dpm_inverse_and_thresholding_match_jax(init):
    sj, sp = _solvers("dpmsolver++",
                      correcting_x0_fn="dynamic_thresholding",
                      thresholding_max_val=0.3)
    x0 = init * 0.1
    kw = dict(steps=10, order=2, method="multistep", t_start=0.05)
    want = np.asarray(sj.inverse(jnp.asarray(x0), **kw))
    got = sp.inverse(torch.from_numpy(x0), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    kw = dict(steps=6, order=2, method="singlestep", t_end=1e-3)
    want = np.asarray(sj.sample(jnp.asarray(init), **kw))
    got = sp.sample(torch.from_numpy(init), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    x = np.random.default_rng(3).standard_normal((3, 50)) * 2.0
    for ratio, mv in ((0.995, 1.0), (0.5, 0.1), (1.0, 1.0)):
        np.testing.assert_allclose(
            pdpm.dynamic_thresholding(torch.from_numpy(x), ratio=ratio,
                                      max_val=mv).numpy(),
            np.asarray(jdpm.dynamic_thresholding(jnp.asarray(x), ratio=ratio,
                                                 max_val=mv)),
            rtol=F64_TOL)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
def test_model_wrapper_types_match_jax(model_type, init):
    """The four parameterisations of one toy model, and classifier-free
    guidance over a dict condition, against JAX's wrapper."""
    nj, np_ = jdpm.NoiseScheduleVP(), pdpm.NoiseScheduleVP()
    t = np.full((SHAPE[0],), 0.7)
    scale = {"noise": 1.0, "x_start": 0.5, "v": -0.3, "score": 2.0}[
        model_type]

    def raw(xp):
        def f(x, tt, cond=None):
            out = xp.tanh(x) * scale + 0.1 * tt.reshape(-1, 1)
            return out if cond is None else out + cond["c"]
        return f

    wj = jdpm.model_wrapper(raw(jnp), nj, model_type=model_type)
    wp = pdpm.model_wrapper(raw(torch), np_, model_type=model_type)
    np.testing.assert_allclose(
        wp(torch.from_numpy(init), torch.from_numpy(t)).numpy(),
        np.asarray(wj(jnp.asarray(init), jnp.asarray(t))), rtol=F64_TOL)
    c, u = np.ones((2, 1)), np.zeros((2, 1))
    cj = jdpm.model_wrapper(raw(jnp), nj, model_type=model_type,
                            guidance_type="classifier-free",
                            condition={"c": jnp.asarray(c)},
                            unconditional_condition={"c": jnp.asarray(u)},
                            guidance_scale=3.0)
    cp = pdpm.model_wrapper(raw(torch), np_, model_type=model_type,
                            guidance_type="classifier-free",
                            condition={"c": torch.from_numpy(c)},
                            unconditional_condition={"c": torch.from_numpy(u)},
                            guidance_scale=3.0)
    np.testing.assert_allclose(
        cp(torch.from_numpy(init), torch.from_numpy(t)).numpy(),
        np.asarray(cj(jnp.asarray(init), jnp.asarray(t))), rtol=F64_TOL)


def test_classifier_guidance_matches_jax(init):
    nj, np_ = jdpm.NoiseScheduleVP(), pdpm.NoiseScheduleVP()
    t = np.full((SHAPE[0],), 0.4)

    def clf(xp):
        return lambda x, tt, y: -((x - y) ** 2).sum(-1) * tt

    wj = jdpm.model_wrapper(lambda x, tt: x * 0.3, nj,
                            guidance_type="classifier", condition=0.5,
                            classifier_fn=clf(jnp), guidance_scale=2.0)
    wp = pdpm.model_wrapper(lambda x, tt: x * 0.3, np_,
                            guidance_type="classifier", condition=0.5,
                            classifier_fn=clf(torch), guidance_scale=2.0)
    np.testing.assert_allclose(
        wp(torch.from_numpy(init), torch.from_numpy(t)).numpy(),
        np.asarray(wj(jnp.asarray(init), jnp.asarray(t))), rtol=F64_TOL)


# -- DEIS ---------------------------------------------------------------------


def _deis_eps(sde, xp):
    def eps(x, t):
        alpha = xp.exp(sde.log_alpha(t))
        return (x - alpha * xp.tanh(x) * 0.5) / xp.sqrt(1.0 - alpha ** 2)
    return eps


@pytest.mark.parametrize("method,kw", [
    ("t_ab", dict(ab_order=1)), ("t_ab", dict(ab_order=2)),
    ("t_ab", dict(ab_order=3)), ("rho_ab", dict(ab_order=1)),
    ("rho_ab", dict(ab_order=3)), ("rho_rk", dict(rk_method="1euler")),
    ("rho_rk", dict(rk_method="3kutta")), ("rho_rk", dict(rk_method="4rk")),
    ("ipndm", {})])
def test_deis_every_method_matches_jax(method, kw, init):
    """Every method on the t and rho grids, float64, and the AB samplers'
    ``run(xT, *run_args)`` equal to the sampler."""
    js, ps = JLinearVPSDE(), LinearVPSDE()
    for phase in ("t", "rho"):
        if method == "ipndm":
            sj = jdeis.get_sampler_ipndm(js, _deis_eps(js, jnp), 10)
            sp = deis.get_sampler_ipndm(ps, _deis_eps(ps, torch), 10)
        else:
            sj = jdeis.get_sampler(js, _deis_eps(js, jnp), phase, 2.0, 10,
                                   method=method, **kw)
            sp = deis.get_sampler(ps, _deis_eps(ps, torch), phase, 2.0, 10,
                                  method=method, **kw)
        want = np.asarray(sj(jnp.asarray(init)))
        x = torch.from_numpy(init)
        got = sp(x).numpy()
        # t_ab of order 3 on the rho grid: large AB weights of both signs,
        # float64 sums in another order meet at ~5e-12 relative
        np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
        if hasattr(sj, "run"):
            assert sp.structure == sj.structure
            for a, b in zip(sp.run_args, sj.run_args):
                np.testing.assert_allclose(a, b, rtol=1e-12)
            args = [torch.from_numpy(np.array(a)) for a in sp.run_args]
            assert torch.equal(sp.run(x, *args), sp(x))


def test_deis_t_ab_float32_matches_jax_and_ni(init):
    """t-AB order 3 on the t grid (the sweep's cell) in float32 against
    JAX, and in float64 against the port's NI with ``deis_tab``
    (tests/test_deis_samplers.py:42)."""
    js, ps = JLinearVPSDE(), LinearVPSDE()
    x32 = init.astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jdeis.get_sampler_t_ab(
            js, _deis_eps(js, jnp), "t", 2.0, 12)(jnp.asarray(x32)))
    got = deis.get_sampler_t_ab(ps, _deis_eps(ps, torch), "t", 2.0, 12)(
        torch.from_numpy(x32))
    assert _rel(got.numpy(), want) < F32_RTOL
    d64 = deis.get_sampler_t_ab(ps, _deis_eps(ps, torch), "t", 2.0, 12)(
        torch.from_numpy(init))
    sched = NISchedule.from_matrix(registry.derive("deis_tab", 12),
                                   device="cpu", dtype=torch.float64)
    ni = natural_inference(lambda z, t: torch.tanh(z) * 0.5, sched,
                           torch.from_numpy(init), prediction_type="x0",
                           accum_dtype=torch.float64)
    np.testing.assert_allclose(d64.numpy(), ni.numpy(), atol=F64_TOL)
