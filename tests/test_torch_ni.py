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
