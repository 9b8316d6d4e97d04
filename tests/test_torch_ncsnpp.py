"""Port's NCSN++ against the JAX package's, with the same weights carried
across by ``load_jax_params``, at a small config (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu_torch.models import layers as L
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import SMALL, random_flax_params, rel_l2

torch.set_num_threads(2)

# f32 on both sides; 18 layers deep, sums in other orders: relative L2
# ~1e-6 expected, bounded at 1e-5
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jm = JaxNCSNpp(config=JaxConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32))["params"],
        jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(0))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"), params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([999.0, 420.0], np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return jm, params, x, t, got


@pytest.mark.parametrize("flag", ["2", None])
def test_forward_matches_jax(pair, monkeypatch, flag):
    """Against the JAX fused-resblock path (NATDIFF_PALLAS_CONV=2, Pallas in
    interpret mode) and the unfused XLA path: the port runs the fused form,
    the same maths as both."""
    jm, params, x, t, got = pair
    if flag is None:
        monkeypatch.delenv("NATDIFF_PALLAS_CONV", raising=False)
    else:
        monkeypatch.setenv("NATDIFF_PALLAS_CONV", flag)
    # a fresh jit per mode: the flag is read at trace time
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


def test_load_jax_params_raises_on_mismatch(pair):
    _, params, _, _, _ = pair
    model = NCSNpp(NCSNppConfig(**SMALL), device="cpu")
    missing = {k: v for k, v in params.items() if k != "m0"}
    with pytest.raises(KeyError, match="m0"):
        load_jax_params(model, missing)
    extra = dict(params, m99={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="m99"):
        load_jax_params(model, extra)
    bad = dict(params, m0=dict(params["m0"],
                               bias=np.zeros(7, np.float32)))
    with pytest.raises(ValueError, match="m0.bias"):
        load_jax_params(model, bad)


def test_load_jax_params_bf16(pair):
    _, params, _, _, _ = pair
    model = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"),
                            params, dtype=torch.bfloat16)
    k = model.layers["m3"].Conv_0.kernel
    assert k.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        k.detach().float().numpy(),
        torch.from_numpy(params["m3"]["Conv_0"]["kernel"]).bfloat16()
        .float().numpy())


def test_walk_matches_the_jax_names(pair):
    """Every resblock holds Conv_0/Conv_1 (two fused-kernel convs), and the
    stem and head are the first and last 3x3 convs."""
    _, params, _, _, _ = pair
    model = NCSNpp(NCSNppConfig(**SMALL), device="cpu")
    blocks = [k for k, m in model.layers.items()
              if isinstance(m, L.ResnetBlockBigGANpp)]
    assert blocks == sorted((k for k, v in params.items() if "Conv_0" in v),
                            key=lambda k: int(k[1:]))
    assert model.layers["m2"].kernel.shape == (3, 3, 3, 128)
    assert model.layers[f"m{len(params) - 1}"].kernel.shape == (3, 3, 128, 3)


@pytest.mark.parametrize("field,value", [("resblock_type", "ddpm")])
def test_unported_options_raise(field, value):
    """No option value of the JAX package is left unported: ``ddpm``, which
    raised ``NotImplementedError`` before ``ResnetBlockDDPMpp`` was ported,
    builds the DDPM++ walk (checked against JAX in
    ``test_torch_ncsnpp_forms.py``); a value neither package knows raises
    ``ValueError``."""
    model = NCSNpp(NCSNppConfig(**dict(SMALL, **{field: value})),
                   device="cpu")
    assert any(isinstance(m, L.ResnetBlockDDPMpp)
               for m in model.layers.values())
    with pytest.raises(ValueError, match=field):
        NCSNpp(NCSNppConfig(**dict(SMALL, **{field: value + "x"})),
               device="cpu")


@pytest.mark.parametrize("field,value", [
    ("fir", True), ("progressive", "output_skip"),
    ("progressive_input", "residual"), ("embedding_type", "fourier"),
    ("scale_by_sigma", True)])
def test_ported_options_match_jax(field, value):
    """Each option of the VE slice on the small CIFAR walk: the JAX tree
    loads, and the f32 forward agrees (the timestep 10 x sigma for the
    Fourier embedding, an index into the sigma table otherwise)."""
    kw = dict(SMALL, **{field: value})
    sigmas = np.linspace(0.01, 50.0, 1000).astype(np.float32)
    jm = JaxNCSNpp(config=JaxConfig(**kw), sigmas=tuple(sigmas.tolist()))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = (np.array([2.5, 0.7], np.float32) if value == "fourier"
         else np.array([999, 420], np.int32))
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: jm.init(k, jnp.asarray(x), jnp.asarray(t))["params"],
            jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(5))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t)))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**kw), sigmas=sigmas,
                                device="cpu"), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.01
    assert rel_l2(got, want) < TOL


# bf16 params and input, port against JAX: the measured control is the
# distance of the JAX bf16 forward from its f32 forward on the same
# weights (9.0e-3 relative L2 here).  The two packages' bf16 runs round at
# other places (the port's fused form rounds the GN+SiLU prologue where
# JAX's XLA route rounds the GroupNorm output; sums run in other orders),
# so each lies about the control from f32, and with independent roundings
# up to sqrt(2) x the control from the other (measured: 1.06x the control
# from JAX's bf16 run, 0.86x from its f32 run).  Bound at 1.5x the
# control, against both; a wrong layer moves the output by O(1)
BF16_CONTROL_FACTOR = 1.5


def test_bf16_forward_matches_jax(pair, monkeypatch):
    """The CIFAR walk in bf16 through both packages: JAX's XLA path (the
    same maths as its fused-resblock path, checked in f32 above) and the
    port's plain versions on the CPU."""
    jm, params, x, t, _ = pair
    monkeypatch.delenv("NATDIFF_PALLAS_CONV", raising=False)

    def run(dtype):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        return np.asarray(jax.jit(
            lambda p, a, b: jm.apply({"params": p}, a, b))(
            p, jnp.asarray(x, dtype), jnp.asarray(t)), np.float32)

    want32, want16 = run(jnp.float32), run(jnp.bfloat16)
    tm = load_jax_params(NCSNpp(NCSNppConfig(**SMALL), device="cpu"), params,
                         dtype=torch.bfloat16)
    with torch.no_grad():
        got16 = tm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(t)).float().numpy()
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 5e-2
    assert np.isfinite(got16).all()
    assert rel_l2(got16, want16) <= BF16_CONTROL_FACTOR * control
    assert rel_l2(got16, want32) <= BF16_CONTROL_FACTOR * control


def test_timestep_embedding_matches_jax():
    from naturaldiffusion_tpu.models.layers import get_timestep_embedding
    t = np.array([0.0, 1.0, 499.5, 999.0], np.float32)
    want = np.asarray(get_timestep_embedding(jnp.asarray(t), 128))
    got = L.get_timestep_embedding(torch.from_numpy(t), 128).numpy()
    # sin/cos of arguments up to 999 rad: one f32 rounding of the argument
    # is ~6e-5 rad there
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
