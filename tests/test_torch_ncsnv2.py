"""The port's RefineNet score networks (``models/ncsnv2.py``: NCSNv2 at
28^2 and 32^2, NCSNv2_128, NCSNv2_256 and the conditional NCSN) against the
JAX package's, the same random weights in both (``load_jax_params``), f32
on the CPU; their layers alone; the size dispatch; the reference's torch
names (``fill_from_torch``); and annealed Langevin over NCSN through
``get_pc_sampler``, fed the noises JAX's sampler draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from naturaldiffusion_tpu import sde as jsde
from naturaldiffusion_tpu.models import convert as jconvert
from naturaldiffusion_tpu.models import ncsnv2 as jn
from naturaldiffusion_tpu.samplers import pc as jpc
from naturaldiffusion_tpu_torch import sde as tsde
from naturaldiffusion_tpu_torch.models import convert
from naturaldiffusion_tpu_torch.models import ncsnv2 as tn
from naturaldiffusion_tpu_torch.samplers import pc
from torch_port_util import jax_params, rel_l2, torch_state_dict

torch.set_num_threads(2)

# f32 on both sides, sums in other orders (as test_torch_ncsnpp.py)
TOL = 1e-5
NF = 8


def _pair(name, image_size, seed=0, num_scales=10, batch=2):
    cfg_kw = dict(nf=NF, image_size=image_size, num_scales=num_scales,
                  sigma_max=1.0)
    jm = getattr(jn, name)(config=jn.NCSNv2Config(**cfg_kw))
    n = image_size
    params = jax_params(jm, jnp.zeros((1, n, n, 3), jnp.float32),
                        jnp.zeros((1,), jnp.int32), seed=seed)
    tm = convert.load_jax_params(
        getattr(tn, name)(tn.NCSNv2Config(**cfg_kw), device="cpu"), params)
    x = np.random.default_rng(seed + 1).uniform(
        size=(batch, n, n, 3)).astype(np.float32)
    labels = np.array([7.6, 2.0][:batch], np.float32)
    return jm, params, tm, x, labels


def _forwards(jm, params, tm, x, labels):
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(labels)), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    return got, want


@pytest.mark.parametrize("name,size", [("NCSNv2", 28), ("NCSNv2", 32),
                                       ("NCSNv2_128", 32),
                                       ("NCSNv2_256", 32), ("NCSN", 32)])
def test_forward_matches_jax(name, size):
    """The four networks: 28^2 takes the ``adjust_padding`` flag, 32^2 the
    plain walk; NCSNv2_256 at 32^2 runs its dilated levels on 4 x 4 maps;
    labels 7.6 and 2.0 (the sigma index and NCSN's class truncate)."""
    jm, params, tm, x, labels = _pair(name, size)
    got, want = _forwards(jm, params, tm, x, labels)
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


def test_instance_norm_plus_matches_jax():
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((2, 5, 7, 6)) + 1.5).astype(np.float32)
    for bias in (True, False):
        jm = jn.InstanceNormPlus(bias=bias)
        params = jax_params(jm, jnp.zeros((1, 5, 7, 6), jnp.float32), seed=4)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        tm = convert.load_jax_params(tn.InstanceNormPlus(6, bias=bias),
                                     params)
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        assert rel_l2(got, want) < TOL


def test_cond_instance_norm_plus_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 4, 6)).astype(np.float32)
    y = np.array([0.0, 3.9, 9.0], np.float32)
    jm = jn.CondInstanceNormPlus(num_classes=10)
    params = jax_params(jm, jnp.zeros((1, 4, 4, 6), jnp.float32),
                        jnp.zeros((1,), jnp.int32), seed=6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(y)))
    tm = convert.load_jax_params(tn.CondInstanceNormPlus(6, 10), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert rel_l2(got, want) < TOL


@pytest.mark.parametrize("out_hw", [(8, 8), (7, 12), (1, 5), (4, 6)])
def test_bilinear_align_corners_matches_jax_and_torch(out_hw):
    x = np.random.default_rng(7).standard_normal((2, 4, 6, 3)).astype(
        np.float32)
    got = tn._bilinear_align_corners(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jn._bilinear_align_corners(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw,
                        mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,adjust", [(3, False), (3, True),
                                           (1, True)])
def test_conv_mean_pool_matches_jax(kernel, adjust):
    """``adjust_padding`` pads a 7 x 7 map to 8 x 8 before the pool."""
    n = 7 if adjust else 8
    x = np.random.default_rng(8).standard_normal((2, n, n, 4)).astype(
        np.float32)
    jm = jn.ConvMeanPool(5, kernel=kernel, adjust_padding=adjust)
    params = jax_params(jm, jnp.zeros((1, n, n, 4), jnp.float32), seed=9)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = convert.load_jax_params(
        tn.ConvMeanPool(4, 5, kernel=kernel, adjust_padding=adjust), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and rel_l2(got, want) < TOL


def test_get_network_dispatch_is_jax():
    for size in (28, 32, 64, 95, 96, 128, 129, 256):
        assert tn.get_network(size).__name__ == \
            jn.get_network(size).__name__
    with pytest.raises(NotImplementedError):
        tn.get_network(257)


@pytest.mark.parametrize("name", ["NCSNv2", "NCSN"])
def test_filled_from_one_state_dict_matches_jax(name):
    """Every leaf's torch name by ``ncsnv2_torch_path_map`` (equal to
    JAX's), the InstanceNorm++ ``alpha``/``gamma``/``beta`` and NCSN's
    ``embed.weight`` among them, filled into both packages."""
    jm, params, tm, x, labels = _pair(name, 32, seed=10)
    sd = torch_state_dict(params, jn.ncsnv2_torch_path_map,
                          np.random.default_rng(11))
    names = [n.rsplit(".", 1)[0] for n, _ in tm.named_parameters()]
    assert all(tn.ncsnv2_torch_path_map(tuple(n.split("."))) ==
               jn.ncsnv2_torch_path_map(tuple(n.split("."))) for n in names)
    assert ("refine1.crp.norms.0.embed.weight" in sd) == (name == "NCSN")
    assert ("res1.0.normalize1.alpha" in sd) == (name == "NCSNv2")
    jparams, junused = jconvert.fill_from_torch(
        params, sd, path_map=jn.ncsnv2_torch_path_map)
    unused = convert.fill_from_torch(tm, sd,
                                     path_map=tn.ncsnv2_torch_path_map)
    assert unused == junused == ["sigmas"]
    got, want = _forwards(jm, jparams, tm, x, labels)
    assert np.abs(want).max() > 0.1 and rel_l2(got, want) < TOL


def _jax_ald_noises(key, shape, n_sigmas, n_steps):
    """The prior and per-step noises of JAX's ``get_pc_sampler`` with the
    ``ald`` corrector and the ``none`` predictor (which draws none: the
    port's predictor noise is then zeros), from its key splits."""
    with jax.enable_x64(False):     # float32 noise, as the sampler draws it
        key, sub = jax.random.split(key)
        prior = np.asarray(jax.random.normal(sub, shape))
        steps = []
        for _ in range(n_sigmas):
            key, kc, _ = jax.random.split(key, 3)
            zc = []
            for _ in range(n_steps):
                kc, sub = jax.random.split(kc)
                zc.append(torch.tensor(np.asarray(
                    jax.random.normal(sub, shape))))
            steps.append((zc, torch.zeros(shape)))
    return prior, steps


def test_ald_over_ncsn_matches_jax_with_its_noises():
    """``ve/ncsn/*``'s sampling (annealed Langevin, no predictor, snr
    0.316) over the small NCSN at its 10 sigmas, 2 steps each, VE
    discrete labels, through both packages' PC samplers."""
    n_steps, snr, shape = 2, 0.316, (2, 32, 32, 3)
    jm, params, tm, _, _ = _pair("NCSN", 32, seed=12)
    jv = jsde.VESDE(sigma_min=0.01, sigma_max=1.0, N=10)
    tv = tsde.VESDE(sigma_min=0.01, sigma_max=1.0, N=10)
    key = jax.random.PRNGKey(13)
    with jax.enable_x64(False):
        jscore = jsde.get_score_fn(jv, lambda a, b: jm.apply(
            {"params": params}, a, b), continuous=False)
        want, wn = jax.jit(jpc.get_pc_sampler(
            jv, jscore, shape, predictor="none", corrector="ald", snr=snr,
            n_steps=n_steps))(key)
        want = np.asarray(want)
    prior, noises = _jax_ald_noises(key, shape, 10, n_steps)
    tscore = tsde.get_score_fn(tv, tm, continuous=False)
    got, gn = pc.get_pc_sampler(
        tv, tscore, shape, predictor="none", corrector="ald", snr=snr,
        n_steps=n_steps, device="cpu")(
        prior=torch.tensor(prior) * tv.sigma_max, noises=noises)
    assert gn == int(wn) == 30
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0.1
    assert rel_l2(got.numpy(), want) < TOL
