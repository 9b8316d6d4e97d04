"""The port's PC inpainter and colorizer (``naturaldiffusion_tpu_torch/
samplers/controllable.py``) against the JAX package's, on the CPU in f32,
fed the prior and the per-step noises that JAX draws from its keys: one
projected step with an analytic score, then whole runs over a small
NCSN++ with one numpy-drawn set of weights in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
from naturaldiffusion_tpu import sde as jsde
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu.samplers import controllable as jc
from naturaldiffusion_tpu_torch import sde as psde
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.samplers import controllable as pc
from torch_port_util import SMALL, random_flax_params, rel_l2

torch.set_num_threads(2)

SHAPE = (2, 8, 8, 3)
# one projected step, analytic score, f32 both sides: a few f32 roundings
STEP_RTOL = 1e-5
# whole runs over the small NCSN++ in f32: the model agrees to ~2e-6
# (test_torch_ncsnpp) and the score divides it by the marginal std, down
# to ~1e-3 at t = eps; relative L2 of the samples
RUN_TOL = 1e-4


def _jax_noises(key, sde_, shape, n_corr):
    """The prior and per-step noises the JAX samplers draw from ``key``:
    ``key, sub = split(key)`` for the prior, then per step ``key, kc, kp,
    k1, k2 = split(key, 5)``, the corrector's own splits of ``kc``, ``k1``
    for the first projection and ``k2`` for the last two."""
    with jax.enable_x64(False):
        key, sub = jax.random.split(key)
        prior = sde_.prior_sampling(sub, shape)
        steps = []
        for _ in range(sde_.N):
            key, kc, kp, k1, k2 = jax.random.split(key, 5)
            zc, k = [], kc
            for _ in range(n_corr):
                k, s = jax.random.split(k)
                zc.append(_t(jax.random.normal(s, shape)))
            steps.append((zc,) + tuple(_t(jax.random.normal(kk, shape))
                                       for kk in (kp, k1, k2)))
    return _t(prior), steps


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _data(seed):
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :, :4] = 1.0                      # the left half is known
    gray = np.repeat(data.mean(-1, keepdims=True), 3, axis=-1)
    return data, mask, gray


def _delta_score(sde_, xp):
    def score(x, t):
        std = sde_.marginal_prob(xp.zeros_like(x), t)[1]
        return -x / std.reshape(-1, 1, 1, 1) ** 2
    return score


def _run_both(kind, jsde_, psde_, jscore, pscore, seed, **kw):
    data, mask, gray = _data(seed)
    n_corr = kw.get("n_steps", 1) if kw.get("corrector",
                                             "langevin") != "none" else 0
    prior, steps = _jax_noises(jax.random.PRNGKey(seed), jsde_, SHAPE,
                               n_corr)
    with jax.enable_x64(False):
        if kind == "inpaint":
            f = jc.get_pc_inpainter(jsde_, jscore, **kw)
            want = jax.jit(f)(jax.random.PRNGKey(seed), jnp.asarray(data),
                              jnp.asarray(mask))
        else:
            f = jc.get_pc_colorizer(jsde_, jscore, **kw)
            want = jax.jit(f)(jax.random.PRNGKey(seed), jnp.asarray(gray))
        want = np.asarray(want)
    if kind == "inpaint":
        got = pc.get_pc_inpainter(psde_, pscore, device="cpu", **kw)(
            None, data, mask, prior=prior, noises=steps)
    else:
        got = pc.get_pc_colorizer(psde_, pscore, device="cpu", **kw)(
            None, gray, prior=prior, noises=steps)
    assert got.dtype == torch.float32 and np.isfinite(want).all()
    return got.numpy(), want, data, mask, gray


@pytest.mark.parametrize("kind", ["inpaint", "colorize"])
@pytest.mark.parametrize("corrector", ["langevin", "none"])
def test_one_projected_step_matches_jax(kind, corrector):
    """N = 1: corrector, projection, predictor, projection of the mean (the
    result, ``denoise``), with the analytic score of data = delta(0)."""
    j, p = jsde.VPSDE(N=1), psde.VPSDE(N=1)
    got, want, *_ = _run_both(kind, j, p, _delta_score(j, jnp),
                              _delta_score(p, torch), 1, corrector=corrector,
                              eps=1e-3)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jm = JaxNCSNpp(config=JaxConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32))["params"],
        jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(11))
    port = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"),
                           params).eval()
    return (lambda x, lab: jm.apply({"params": params}, x, lab)), port


# (kind, N, predictor, corrector, denoise): the samplers' defaults at N =
# 25 (the VP discretisation's largest beta, beta_max / N, must stay under
# 1: at N = 10 the reverse-diffusion step and the Langevin step take the
# root of a negative number, in both packages), and the VP CIFAR config's
# euler_maruyama + none at N = 10
RUNS = (("inpaint", 25, "reverse_diffusion", "langevin", True),
        ("colorize", 25, "reverse_diffusion", "langevin", True),
        ("inpaint", 10, "euler_maruyama", "none", False),
        ("colorize", 10, "euler_maruyama", "none", True))


@pytest.mark.parametrize("kind,n,predictor,corrector,denoise", RUNS)
def test_whole_run_matches_jax_on_a_small_ncsnpp(models, kind, n, predictor,
                                                 corrector, denoise):
    japply, port = models
    j, p = jsde.VPSDE(N=n), psde.VPSDE(N=n)
    with torch.no_grad():
        got, want, data, mask, gray = _run_both(
            kind, j, p, jsde.get_score_fn(j, japply, continuous=True),
            psde.get_score_fn(p, port, continuous=True), 2, snr=0.16,
            n_steps=1, denoise=denoise, predictor=predictor,
            corrector=corrector)
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < RUN_TOL
    if kind == "inpaint" and denoise:
        # the last projection of the mean sets the known pixels to the
        # data's marginal mean at t = eps, within 1e-5 of the data
        np.testing.assert_allclose(got[mask == 1], data[mask == 1],
                                   atol=1e-4)
    if kind == "colorize":
        lum = pc.decouple(torch.from_numpy(got))[..., 0].numpy()
        np.testing.assert_allclose(
            lum, pc.decouple(torch.from_numpy(gray))[..., 0].numpy(),
            atol=1e-4)


def test_color_matrices_and_drawn_noises():
    np.testing.assert_array_equal(pc._M, jc._M)
    np.testing.assert_array_equal(pc._INV_M, jc._INV_M)
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    for f, g in ((pc.decouple, jc.decouple), (pc.couple, jc.couple)):
        np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(),
                                   np.asarray(g(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pc.couple(pc.decouple(torch.from_numpy(x))),
                               x, atol=1e-5)
    # without given noises the samplers draw them from the generator
    p = psde.VPSDE(N=2)
    run = pc.get_pc_inpainter(p, _delta_score(p, torch), device="cpu",
                              predictor="euler_maruyama", corrector="none",
                              eps=1e-3)
    data, mask, _ = _data(4)
    a = run(torch.Generator().manual_seed(1), data, mask)
    b = run(torch.Generator().manual_seed(1), data, mask)
    c = run(torch.Generator().manual_seed(2), data, mask)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(KeyError, match="unknown corrector"):
        pc.get_pc_colorizer(p, None, corrector="nope", device="cpu")
