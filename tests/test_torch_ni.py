"""The port's first slice as a whole: Natural Inference over the small
NCSN++ against the JAX package's NI scan with the fused kernels, and the
engine against the float64 reference loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.coeffs import registry as jax_registry
from naturaldiffusion_tpu.engine import NISchedule as JaxSchedule
from naturaldiffusion_tpu.engine import natural_inference as jax_ni
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.engine import (NISchedule, natural_inference,
                                               natural_inference_reference)
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import SMALL, random_flax_params, rel_l2

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["ddpm", "ddim"])
@pytest.mark.parametrize("n", [4, 10])
def test_matrices_equal_jax(name, n):
    a, b = registry.derive(name, n), jax_registry.derive(name, n)
    for f in ("x0", "eps", "node"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_slice_matches_jax_scan_with_kernels(monkeypatch):
    """eps-prediction DDPM NI over the small NCSN++: the port (CPU, f32,
    through make_sampler in chunks of one image) against the JAX scan with
    the fused weighted-sum kernel and NATDIFF_PALLAS_CONV=2 (interpret
    mode), fed the same numpy noises."""
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    n, b = 4, 2
    matrix = registry.derive("ddpm", n)
    jm = JaxNCSNpp(config=JaxConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32))["params"],
        jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    init = rng.standard_normal((b, 8, 8, 3)).astype(np.float32)
    noises = rng.standard_normal((n, b, 8, 8, 3)).astype(np.float32)

    def eps_fn(z, t):
        return jm.apply({"params": params}, z, jnp.full((b,), t, jnp.float32))

    want = np.asarray(jax.jit(lambda z, e: jax_ni(
        eps_fn, JaxSchedule.from_matrix(matrix), z, noises=e,
        prediction_type="eps", unroll=False, use_pallas=True))(
            jnp.asarray(init), jnp.asarray(noises)))

    model = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"),
                            params)
    run = make_sampler(model, matrix, micro=1, dtype=torch.float32,
                       device="cpu")
    got = run(torch.from_numpy(init), noises=torch.from_numpy(noises))
    assert got.dtype == torch.float32 and got.shape == (b, 8, 8, 3)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    # f32 model differences (~2e-6, test_torch_ncsnpp) are amplified by
    # 1/alpha (~160 at t=999) in eps -> x0, then damped by the small x0
    # weight of the first steps
    assert rel_l2(got.numpy(), want) < 1e-4


def _toy_torch(z, t):
    return torch.tanh(0.5 * z) + t / 1000.0


def _toy_numpy(z, t):
    return np.tanh(0.5 * z) + t / 1000.0


@pytest.mark.parametrize("name,ptype", [("ddpm", "eps"), ("ddim", "eps"),
                                        ("ddpm", "x0")])
def test_engine_matches_fp64_reference(name, ptype):
    n = 10
    matrix = registry.derive(name, n)
    rng = np.random.default_rng(4)
    init = rng.standard_normal((3, 4, 4, 3))
    noises = rng.standard_normal((n, 3, 4, 4, 3))
    want = natural_inference_reference(_toy_numpy, matrix, init,
                                       noises=noises, prediction_type=ptype)
    got = natural_inference(
        _toy_torch, NISchedule.from_matrix(matrix, device="cpu"),
        torch.tensor(init, dtype=torch.float32),
        noises=torch.tensor(noises, dtype=torch.float32),
        prediction_type=ptype)
    # f32 against f64 over 10 steps; eps -> x0 divides by alpha ~ 6e-3
    assert rel_l2(got.numpy(), want) < 1e-5


def test_stochastic_noise_sources():
    matrix = registry.derive("ddpm", 3)
    sched = NISchedule.from_matrix(matrix, device="cpu")
    init = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError, match="noises"):
        natural_inference(_toy_torch, sched, init)
    outs = [natural_inference(_toy_torch, sched, init,
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_matrix_load_reads_the_jax_files(tmp_path):
    """``--weights`` files: what the JAX package saves, the port loads."""
    from naturaldiffusion_tpu_torch.coeffs.matrix import CoeffMatrix
    path = str(tmp_path / "m.npz")
    jax_registry.derive("ddpm", 6).save(path)
    got, want = CoeffMatrix.load(path), registry.derive("ddpm", 6)
    for f in ("x0", "eps", "node"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("ptype", ["eps", "x0", "score", "v_flow", "v_vp"])
def test_from_x0_round_trips_and_equals_jax(ptype):
    from naturaldiffusion_tpu.engine.predictions import from_x0 as jax_from
    from naturaldiffusion_tpu_torch.engine import from_x0, to_x0
    rng = np.random.default_rng(6)
    x0, x = rng.standard_normal((2, 3, 4, 4, 3))
    alpha, sigma = 0.6, 0.8
    pred = from_x0(torch.from_numpy(x0), torch.from_numpy(x), alpha, sigma,
                   ptype)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jax_from(
        jnp.asarray(x0), jnp.asarray(x), alpha, sigma, ptype)), rtol=1e-12,
        atol=1e-12)
    back = to_x0(pred, torch.from_numpy(x), alpha, sigma, ptype,
                 accum_dtype=torch.float64)
    assert back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), x0, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="prediction_type"):
        from_x0(pred, pred, alpha, sigma, "nope")


@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_to_x0_accum_dtype_equals_jax(accum):
    from naturaldiffusion_tpu.engine.predictions import to_x0 as jax_to
    from naturaldiffusion_tpu_torch.engine import to_x0
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    alpha, sigma = 6.4e-3, 0.99998
    got = to_x0(torch.from_numpy(pred), torch.from_numpy(x), alpha, sigma,
                "eps", accum_dtype=getattr(torch, accum))
    want = np.asarray(jax_to(jnp.asarray(pred), jnp.asarray(x), alpha, sigma,
                             "eps", accum_dtype=getattr(jnp, accum)))
    assert str(got.dtype).endswith(accum) and want.dtype == np.dtype(accum)
    tol = 1e-12 if accum == "float64" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_engine_float64_matches_reference():
    """``accum_dtype=float64`` on the CPU: the engine's buffers, sums and
    coefficients in float64 against the float64 reference loop; the card
    refuses it (K1 sums in float32)."""
    n = 10
    matrix = registry.derive("ddpm", n)
    rng = np.random.default_rng(8)
    init = rng.standard_normal((2, 4, 4, 3))
    noises = rng.standard_normal((n, 2, 4, 4, 3))
    want = natural_inference_reference(_toy_numpy, matrix, init,
                                       noises=noises, prediction_type="eps")
    sched = NISchedule.from_matrix(matrix, device="cpu", dtype=torch.float64)
    got = natural_inference(_toy_torch, sched, torch.from_numpy(init),
                            noises=torch.from_numpy(noises),
                            prediction_type="eps", accum_dtype=torch.float64)
    assert got.dtype == torch.float64
    assert rel_l2(got.numpy(), want) < 1e-12
    with pytest.raises(ValueError, match="CPU only"):
        natural_inference(_toy_torch, sched, torch.zeros(1, 4, device="meta"),
                          accum_dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        natural_inference(_toy_torch, sched, torch.zeros(1, 4),
                          accum_dtype=torch.float16)


def test_checked_raises_on_a_poisoned_schedule():
    """A NaN coefficient reaches the samples: the checked engine raises on
    the host after the loop, as the JAX one throws under checkify; a sound
    schedule returns what ``natural_inference`` returns."""
    from naturaldiffusion_tpu.engine import natural_inference_checked as jchk
    from naturaldiffusion_tpu_torch.engine import natural_inference_checked
    from naturaldiffusion_tpu_torch.coeffs.matrix import CoeffMatrix
    n = 4
    good = registry.derive("ddim", n)
    x0 = good.x0.copy()
    x0[2, 1] = np.nan
    bad = CoeffMatrix(x0=x0, eps=good.eps, node=good.node)
    init = np.random.default_rng(9).standard_normal((2, 4, 4, 3))
    z = torch.tensor(init, dtype=torch.float32)
    out = natural_inference_checked(
        _toy_torch, NISchedule.from_matrix(good, device="cpu"), z)
    torch.testing.assert_close(out, natural_inference(
        _toy_torch, NISchedule.from_matrix(good, device="cpu"), z),
        rtol=0, atol=0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        natural_inference_checked(
            _toy_torch, NISchedule.from_matrix(bad, device="cpu"), z)
    with pytest.raises(Exception, match="non-finite|nan"):
        jchk(lambda zz, t: jnp.tanh(0.5 * zz) + t / 1000.0,
             JaxSchedule.from_matrix(bad), jnp.asarray(init, jnp.float32))


@pytest.mark.parametrize("name", ["ddpm", "sde_euler"])
def test_reference_default_noises_equal_jax(name):
    """Without ``noises`` a stochastic matrix draws step k's noise from
    ``default_rng(1000 + k)`` in both packages."""
    from naturaldiffusion_tpu.engine import (
        natural_inference_reference as jax_ref)
    matrix = registry.derive(name, 6)
    assert not matrix.is_deterministic
    init = np.random.default_rng(10).standard_normal((2, 4, 4, 3))
    got = natural_inference_reference(_toy_numpy, matrix, init,
                                      prediction_type="eps")
    want = jax_ref(_toy_numpy, jax_registry.derive(name, 6), init,
                   prediction_type="eps")
    np.testing.assert_array_equal(got, want)
    noises = np.stack([np.random.default_rng(1000 + k).standard_normal(
        init.shape) for k in range(6)])
    np.testing.assert_array_equal(got, natural_inference_reference(
        _toy_numpy, matrix, init, noises=noises, prediction_type="eps"))
