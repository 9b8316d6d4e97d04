"""The port's VE NCSN++ (FIR, Fourier embedding, progressive paths,
scale_by_sigma, uncentered input) against the JAX package's, with the same
weights carried across by ``load_jax_params``, on the CPU; and the port's
VE configs against the JAX package's, field by field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.configs import get_config as jax_get_config
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu.ops import conv3x3 as jconv
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.ops import conv3x3 as tconv
from torch_port_util import random_flax_params, rel_l2

torch.set_num_threads(2)

# the small VE model: image 16, nf 16, ch_mult (1,2,2), one block per level,
# attention at 8, FIR, Fourier, scale_by_sigma, uncentered
VE_SMALL = dict(image_size=16, nf=16, ch_mult=(1, 2, 2), num_res_blocks=1,
                attn_resolutions=(8,), fir=True, embedding_type="fourier",
                scale_by_sigma=True, centered=False)
# the same at nf 128 and image 8 (ch_mult (1, 2), attention at 4), where
# the resblocks can take the fused form (channel counts multiples of 128)
VE_WIDE = dict(VE_SMALL, image_size=8, nf=128, ch_mult=(1, 2),
               attn_resolutions=(4,), progressive="output_skip",
               progressive_input="input_skip")
# f32 on both sides, ~20 layers of f32 sums in other orders: sound runs
# read 6e-7 to 9e-7 relative L2; bounded at 1e-5
TOL = 1e-5
# bf16 params and inputs, port against JAX: the measured control is the
# distance of the JAX bf16 run from the JAX f32 run of the same weights
# (1.22e-2 relative L2 on this model).  The two packages round at other
# places (the port's GroupNorm adds the temb bias in f32, JAX's XLA route in
# bf16; the sums run in other orders), so their two bf16 runs each lie about
# the control from f32 and, with independent roundings, up to sqrt(2) times
# the control from each other (measured: 0.87x the control from JAX's bf16
# run, 1.01x from its f32 run).  Bound at 1.5x the control, against both;
# a wrong layer moves the output by O(1)
BF16_CONTROL_FACTOR = 1.5

# (progressive, progressive_input, combine, fir): without FIR the
# resampling is nearest / average pooling, and the residual paths' convs
# are the 3x3 conv after the nearest upsample and the stride-2 conv
PROGRESSIVE = [("output_skip", "input_skip", "sum", True),
               ("output_skip", "input_skip", "cat", True),
               ("residual", "residual", "sum", True),
               ("residual", "input_skip", "cat", True),
               ("none", "none", "sum", True),
               ("residual", "residual", "sum", False),
               ("output_skip", "input_skip", "sum", False)]


def _pair(kw, seed=0):
    jm = JaxNCSNpp(config=JaxConfig(**kw))
    x = np.random.default_rng(seed + 1).uniform(
        0, 1, (2, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    sigma = np.array([50.0, 0.3], np.float32)
    # shapes in float32 mode: under x64 the JAX init makes the FIR convs'
    # weights float64, which its float32 convs refuse
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: jm.init(k, jnp.asarray(x),
                              jnp.asarray(sigma))["params"],
            jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(seed))
    return jm, params, x, sigma


def _jax(jm, params, x, sigma, dtype=jnp.float32):
    """JAX's forward, jitted (on the CPU a compile is cheaper than running
    the ops one by one); a fresh jit per call, as the flags are read at
    trace time."""
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    fwd = jax.jit(lambda p, a, s: jm.apply({"params": p}, a, s))
    return np.asarray(fwd(p, jnp.asarray(x, dtype), jnp.asarray(sigma)),
                      np.float32)


def _port(kw, params, x, sigma, dtype=torch.float32):
    tm = load_jax_params(NCSNpp(NCSNppConfig(**kw), device="cpu"), params,
                         dtype=dtype)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(dtype), torch.from_numpy(sigma))
    return out.float().numpy()


@pytest.mark.parametrize("prog,prog_in,combine,fir", PROGRESSIVE)
def test_ve_forward_matches_jax(prog, prog_in, combine, fir, monkeypatch):
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    kw = dict(VE_SMALL, progressive=prog, progressive_input=prog_in,
              progressive_combine=combine, fir=fir)
    jm, params, x, sigma = _pair(kw)
    want = _jax(jm, params, x, sigma)
    got = _port(kw, params, x, sigma)
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


@pytest.mark.parametrize("form", ["fused", "unfused_tiled"])
def test_ve_wide_forward_matches_jax(form, monkeypatch):
    """At nf 128 the resblocks take the fused form in both packages (JAX
    under ``NATDIFF_PALLAS_CONV=2``, its Pallas kernels in interpret mode).
    With the route predicate patched in both packages so that no
    whole-image conv fits, every resblock takes the unfused form and every
    128-channel conv the halo-tiled one (K4 here, JAX's ``tiled``)."""
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    calls = []
    if form == "unfused_tiled":
        def only_tiled(fits):
            def patched(shape, cout, itemsize, variant="valid9", **kw):
                calls.append(variant)
                return (variant in ("tiled", "tiledew")
                        and fits(shape, cout, itemsize, variant, **kw))
            return patched
        monkeypatch.setattr(jconv, "pallas_conv_fits",
                            only_tiled(jconv.pallas_conv_fits))
        monkeypatch.setattr(tconv, "pallas_conv_fits",
                            only_tiled(tconv.pallas_conv_fits))
    jm, params, x, sigma = _pair(VE_WIDE, seed=3)
    want = _jax(jm, params, x, sigma)
    counts = (tconv.conv3x3_gn.launches, tconv.conv3x3_tiled.launches)
    got = _port(VE_WIDE, params, x, sigma)
    assert (tconv.conv3x3_gn.launches, tconv.conv3x3_tiled.launches) == counts
    if form == "unfused_tiled":
        assert "tiled" in calls
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


def test_ve_bf16_forward_matches_jax():
    """bf16 params and input through both packages, against the measured
    bf16-vs-f32 control of the JAX package on the same weights."""
    kw = dict(VE_SMALL, progressive="output_skip",
              progressive_input="input_skip")
    jm, params, x, sigma = _pair(kw, seed=5)
    want32 = _jax(jm, params, x, sigma)
    want16 = _jax(jm, params, x, sigma, jnp.bfloat16)
    got16 = _port(kw, params, x, sigma, torch.bfloat16)
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 5e-2           # bf16 is visible, and sane
    assert np.isfinite(got16).all()
    assert rel_l2(got16, want16) <= BF16_CONTROL_FACTOR * control
    assert rel_l2(got16, want32) <= BF16_CONTROL_FACTOR * control


VE_CONFIGS = ["ve/celebahq_256_ncsnpp_continuous",
              "ve/ffhq_256_ncsnpp_continuous", "ve/church_ncsnpp_continuous",
              "ve/bedroom_ncsnpp_continuous", "ve/celeba_ncsnpp",
              "ve/cifar10_ncsnpp_continuous"]


@pytest.mark.parametrize("name", VE_CONFIGS)
def test_configs_match_jax_field_by_field(name):
    mine, ref = configs.get_config(name), jax_get_config(name)
    assert mine.name == ref.name and ref.model_family == "ncsnpp"
    for f in dataclasses.fields(mine.model):
        assert getattr(mine.model, f.name) == getattr(ref.model, f.name), f
    for f in dataclasses.fields(mine.sde):
        assert getattr(mine.sde, f.name) == getattr(ref.training, f.name), f
    assert dataclasses.asdict(mine.sampling) == dataclasses.asdict(
        ref.sampling)
    sde = configs.get_sde(mine)
    assert (sde.sigma_min, sde.sigma_max, sde.N) == (
        ref.training.sigma_min, ref.training.sigma_max,
        ref.training.num_scales)


def test_celebahq_256_builds_the_jax_tree_at_full_width():
    """65.6 M parameters, every JAX leaf placed and every port parameter
    filled (shapes only: no forward at this size on the CPU)."""
    cfg = configs.get_config("ve/celebahq_256_ncsnpp_continuous").model
    jm = JaxNCSNpp(config=jax_get_config(
        "ve/celebahq_256_ncsnpp_continuous").model)
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 256, 256, 3)),
                          jnp.ones((1,)))["params"], jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert sum(int(np.prod(a.shape)) for a in leaves) == 65_574_549
    model = NCSNpp(cfg, device="cpu")
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes)
    load_jax_params(model, zeros)
    assert sum(p.numel() for p in model.parameters()) == 65_574_549
    with pytest.raises(KeyError, match="m0"):
        load_jax_params(model, {k: v for k, v in zeros.items() if k != "m0"})


def test_scale_by_sigma_positional_needs_the_sigma_table():
    kw = dict(VE_SMALL, embedding_type="positional")
    with pytest.raises(ValueError, match="sigmas"):
        NCSNpp(NCSNppConfig(**kw), device="cpu")
    model = NCSNpp(NCSNppConfig(**kw), sigmas=np.linspace(0.01, 50, 10),
                   device="cpu")
    with torch.no_grad():
        out = model(torch.rand(2, 16, 16, 3), torch.tensor([9, 0]))
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
