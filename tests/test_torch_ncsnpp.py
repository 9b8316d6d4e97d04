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


@pytest.mark.parametrize("field,value", [
    ("resblock_type", "ddpm"), ("fir", True), ("progressive", "output_skip"),
    ("progressive_input", "residual"), ("embedding_type", "fourier"),
    ("scale_by_sigma", True)])
def test_unported_options_raise(field, value):
    cfg = NCSNppConfig(**dict(SMALL, **{field: value}))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        NCSNpp(cfg, device="cpu")


def test_timestep_embedding_matches_jax():
    from naturaldiffusion_tpu.models.layers import get_timestep_embedding
    t = np.array([0.0, 1.0, 499.5, 999.0], np.float32)
    want = np.asarray(get_timestep_embedding(jnp.asarray(t), 128))
    got = L.get_timestep_embedding(torch.from_numpy(t), 128).numpy()
    # sin/cos of arguments up to 999 rad: one f32 rounding of the argument
    # is ~6e-5 rad there
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
