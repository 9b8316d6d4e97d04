"""The port's original DDPM UNet (``models/ddpm.py``) against the JAX
package's, the same random weights in both (``load_jax_params``), f32 on the
CPU: every option flipped, each form of the conv switch and two int8 modes
(JAX reads its switches at trace time: a fresh jit per mode), Natural
Inference through both packages' ``make_sampler``, and weights filled from
one reference-layout state dict (``fill_from_torch``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.apps import cifar10_ni as jax_cifar10_ni
from naturaldiffusion_tpu.coeffs import registry as jax_registry
from naturaldiffusion_tpu.models import convert as jconvert
from naturaldiffusion_tpu.models import ddpm as jddpm
from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.models import convert
from naturaldiffusion_tpu_torch.models.ddpm import (DDPM, DDPMConfig,
                                                    ddpm_torch_path_map)
from torch_port_util import jax_params, rel_l2, torch_state_dict

torch.set_num_threads(2)

# f32 on both sides, sums in other orders (as test_torch_ncsnpp.py)
TOL = 1e-5
# nf 32: GroupNorm's 32 groups are one channel wide at 32 channels, where
# NCSN++'s rule would take 8, so a wrong group count shows; attention at 4^2
SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
             image_size=8)
# channels multiples of 128, so the JAX package's Pallas convs (interpret
# mode) and the int8 convs are on the path, with one resampling each way
WIDE = dict(nf=128, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(4,),
            image_size=8)
# int8 forwards, port against JAX: the limits of the JAX package's own
# int8 model test (tests/test_quant.py:89-94); see test_torch_ncsnpp_forms.py
# for why the model-level check is coarse
INT8_REL, INT8_COS = 5e-2, 0.99
# labels: timesteps of the embedding; 420.7 checks that scale_by_sigma
# truncates the sigma index as JAX's astype(int32)
LABELS = np.array([999.0, 420.7], np.float32)

OPTIONS = {
    "base": {},
    "unconditional": dict(conditional=False),
    "scale_by_sigma": dict(scale_by_sigma=True, num_scales=1000),
    "no_resamp_conv": dict(resamp_with_conv=False),
    "uncentered": dict(centered=False),
}


def _pair(cfg_kw, seed=0, sigmas=None):
    n = cfg_kw["image_size"]
    jm = jddpm.DDPM(config=jddpm.DDPMConfig(**cfg_kw),
                    sigmas=() if sigmas is None else tuple(sigmas))
    params = jax_params(jm, jnp.zeros((1, n, n, 3), jnp.float32),
                        jnp.zeros((1,), jnp.float32), seed=seed)
    tm = convert.load_jax_params(
        DDPM(DDPMConfig(**cfg_kw), sigmas=sigmas, device="cpu"), params)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, n, n, 3)).astype(np.float32)
    return jm, params, tm, x


def _jax_forward(jm, params, x, t=LABELS):
    # a fresh jit per call: the switches are read at trace time
    return np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)), np.float32)


def _port_forward(tm, x, t=LABELS):
    with torch.no_grad():
        return tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()


def _env(monkeypatch, flag, quant=""):
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", flag)
    if quant:
        monkeypatch.setenv("NATDIFF_QUANT", quant)
    else:
        monkeypatch.delenv("NATDIFF_QUANT", raising=False)


@pytest.fixture(scope="module")
def wide():
    return _pair(WIDE, seed=10)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_forward_matches_jax(option):
    jm, params, tm, x = _pair(dict(SMALL, **OPTIONS[option]))
    got, want = _port_forward(tm, x), _jax_forward(jm, params, x)
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


def test_given_sigma_table_matches_jax():
    """``scale_by_sigma`` with the sigma table given (JAX's
    ``DDPM.sigmas``) instead of the config's geometric one."""
    sigmas = np.geomspace(80.0, 0.02, 1000).astype(np.float32)
    jm, params, tm, x = _pair(dict(SMALL, scale_by_sigma=True), seed=3,
                              sigmas=sigmas)
    got, want = _port_forward(tm, x), _jax_forward(jm, params, x)
    assert rel_l2(got, want) < TOL


def test_module_walk_is_jax_tree():
    """The walk's names are JAX's, numbers skipped with the resampling
    convs; GroupNorms take 32 groups (NCSN++'s rule would take 8 at 32
    channels)."""
    for kw in ({}, dict(resamp_with_conv=False)):
        cfg = dict(SMALL, **kw)
        jm, params, tm, _ = _pair(cfg)
        assert list(tm.layers) == sorted(params, key=lambda k: int(
            k[1:].split("_")[0]))
        resamp = [k for k in tm.layers if k.endswith("_Conv_0")]
        assert resamp == ([] if kw else ["m4_Conv_0", "m13_Conv_0"])
    gns = [m for m in tm.modules() if type(m).__name__ == "GroupNorm"]
    assert gns and {g.num_groups for g in gns} == {32}


@pytest.mark.parametrize("flag", ["0", "1", "2"])
def test_switch_forms_match_jax(wide, monkeypatch, flag):
    """Each form of the conv switch, both packages under it: JAX's Pallas
    convs (interpret mode) under ``1``/``2`` at these 128-channel maps, the
    port's K2 plain version under ``1``/``2``, the library conv under
    ``0``.  DDPM has no fused form in either package."""
    jm, params, tm, x = wide
    _env(monkeypatch, flag)
    got, want = _port_forward(tm, x), _jax_forward(jm, params, x)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


@pytest.mark.parametrize("quant", ["int8_static", "int8"])
def test_int8_forward_matches_jax(wide, monkeypatch, quant):
    jm, params, tm, x = wide
    _env(monkeypatch, "0", quant)
    got, want = _port_forward(tm, x), _jax_forward(jm, params, x)
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert np.isfinite(got).all()
    assert rel_l2(got, want) < INT8_REL and cos > INT8_COS


class _NoMods:
    """JAX's ``make_sampler`` calls ``model.apply(..., mods=None)``, a
    keyword of its NCSN++ that its DDPM does not take: this drops it."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, x, t, mods=None):
        assert mods is None
        return self.module.apply(variables, x, t)


def test_ni_over_ddpm_matches_jax_make_sampler():
    """3-step DDIM NI (deterministic: no noises to share) over the small
    DDPM through both packages' ``cifar10_ni.make_sampler``, f32, two
    micro-batches of one image."""
    n = 3
    jm, params, tm, _ = _pair(SMALL, seed=5)
    init = np.random.default_rng(6).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    jrun = jax_cifar10_ni.make_sampler(
        params, _NoMods(jm), jax_registry.derive("ddim", n), batch=2,
        micro=1, dtype=jnp.float32)
    want = np.asarray(jrun(jnp.asarray(init), jax.random.PRNGKey(0)))
    run = make_sampler(tm, registry.derive("ddim", n), micro=1,
                       dtype=torch.float32, device="cpu")
    got = run(torch.from_numpy(init)).numpy()
    assert got.shape == (2, 8, 8, 3) and np.abs(want).max() > 0.1
    # f32 model differences amplified by 1/alpha in eps -> x0 (as
    # test_torch_ni.py)
    assert rel_l2(got, want) < 1e-4


def test_filled_from_one_state_dict_matches_jax():
    cfg = SMALL
    jm = jddpm.DDPM(config=jddpm.DDPMConfig(**cfg))
    template = jax_params(jm, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32), seed=7)
    sd = torch_state_dict(template, jddpm.ddpm_torch_path_map,
                          np.random.default_rng(8))
    for key in ("m4_Conv_0", "m12", "m13_Conv_0", "m0"):
        assert ddpm_torch_path_map((key, "Conv_0")) == \
            jddpm.ddpm_torch_path_map((key, "Conv_0"))
    params, junused = jconvert.fill_from_torch(
        template, sd, path_map=jddpm.ddpm_torch_path_map)
    model = DDPM(DDPMConfig(**cfg), device="cpu")
    unused = convert.fill_from_torch(model, sd, path_map=ddpm_torch_path_map)
    assert unused == junused == ["sigmas"]
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    got, want = _port_forward(model, x), _jax_forward(jm, params, x)
    assert np.abs(want).max() > 0.1 and rel_l2(got, want) < TOL
    with pytest.raises(KeyError, match="all_modules.4.Conv_0"):
        convert.fill_from_torch(model, {
            k: v for k, v in sd.items()
            if not k.startswith("all_modules.4.Conv_0")},
            path_map=ddpm_torch_path_map)


def test_config_fields_are_jax_less_dropout():
    mine = {f.name for f in dataclasses.fields(DDPMConfig)}
    ref = {f.name for f in dataclasses.fields(jddpm.DDPMConfig)}
    assert mine == ref - {"dropout"}
