"""The port's NCSN++ in every form the JAX package has, against the JAX
package with the same weights (``load_jax_params``) on the CPU: the route
switch (``NATDIFF_PALLAS_CONV``) and the int8 modes (``NATDIFF_QUANT``),
``resblock_type="ddpm"``, and the hoisted conditioning (``mods=``,
``ncsnpp_schedule_biases``).  JAX reads these variables at trace time, so
every mode jits a fresh function."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu.models.ncsnpp import (
    ncsnpp_schedule_biases as jax_biases)
from naturaldiffusion_tpu.ops import quant as jq
from naturaldiffusion_tpu_torch.models import layers as L
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import (NCSNpp, NCSNppConfig,
                                                      ncsnpp_schedule_biases)
from naturaldiffusion_tpu_torch.ops import quant as tq
from torch_port_util import SMALL, random_flax_params, rel_l2

torch.set_num_threads(2)

# f32 on both sides, sums in other orders (as test_torch_ncsnpp.py)
TOL = 1e-5
# the int8 config of tests/test_quant.py (XLA:CPU runs s8 convs on a slow
# path: one block at 8^2), with attention at 8^2 so the NINs are on it
QSMALL = dict(nf=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(8,),
              image_size=8)
# int8 forwards, port against JAX, relative L2 and cosine: the limits of
# the JAX package's own int8 model test (tests/test_quant.py:89-94).  The
# port's int8 operands equal JAX's on equal inputs (test_torch_quant.py),
# but the two forwards' f32 activations differ in last bits (1.9e-6 here
# without quantization), and each such difference at a rounding boundary
# flips a whole int8 step.  Measured on this config: port against JAX
# 6.6e-3 (int8), 1.8e-2 (int8_static), 2.0e-2 (int8_all_static); JAX
# against itself with every weight scaled by 1 + 1e-6 noise 2.2e-2,
# 3.0e-2, 5.1e-2; quantization itself (JAX int8 against JAX f32) 2.8e-2,
# 3.8e-2, 5.5e-2.  So the model-level check is coarse, and the conv-level
# one below (each int8 conv of the port's forward against JAX's
# conv3x3_int8 on the same input and the JAX tree's weights) is the tight
# one.
INT8_REL, INT8_COS = 5e-2, 0.99
# one dequant rounding, as test_torch_quant.py
ULP = 2 * 2.0 ** -23


def _build(cfg_kw, seed=0):
    jm = JaxNCSNpp(config=JaxConfig(**cfg_kw))
    n = cfg_kw["image_size"]
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: jm.init(k, jnp.zeros((1, n, n, 3), jnp.float32),
                              jnp.zeros((1,), jnp.float32))["params"],
            jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(seed))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**cfg_kw), device="cpu"),
                         params)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
    t = np.array([999.0, 420.0], np.float32)
    return jm, params, tm, x, t


@pytest.fixture(scope="module")
def small():
    return _build(SMALL)


@pytest.fixture(scope="module")
def qsmall():
    return _build(QSMALL)


def _env(monkeypatch, flag, quant):
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", flag)
    if quant:
        monkeypatch.setenv("NATDIFF_QUANT", quant)
    else:
        monkeypatch.delenv("NATDIFF_QUANT", raising=False)


def _jax_forward(jm, params, x, t, **kw):
    # a fresh jit per call: the switches are read at trace time
    return np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b,
                                                       **kw))(
        params, jnp.asarray(x), jnp.asarray(t)))


def _port_forward(tm, x, t, **kw):
    with torch.no_grad():
        return tm(torch.from_numpy(x), torch.from_numpy(t), **kw).numpy()


@pytest.mark.parametrize("flag", ["1", "0"])
def test_float_routes_match_jax(small, monkeypatch, flag):
    """Each unfused route of the switch without quantization, the conv
    kernels (``1``) and the library conv (``0``), against JAX's unfused XLA
    form: one function (which implementation each conv takes is
    ``test_torch_routes.py``'s; ``2``, the fused kernels, is
    ``test_torch_ncsnpp.py::test_forward_matches_jax``)."""
    jm, params, tm, x, t = small
    _env(monkeypatch, flag, "")
    got = _port_forward(tm, x, t)
    _env(monkeypatch, "0", "")
    want = _jax_forward(jm, params, x, t)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


@pytest.mark.parametrize("quant", ["int8", "int8_static", "int8_all_static"])
def test_int8_forward_matches_jax(qsmall, monkeypatch, quant):
    """The model under ``NATDIFF_PALLAS_CONV=0`` and an int8 mode (bench.py's
    form), against JAX's in the same mode (see INT8_REL)."""
    jm, params, tm, x, t = qsmall
    _env(monkeypatch, "0", quant)
    got, want = _port_forward(tm, x, t), _jax_forward(jm, params, x, t)
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert np.isfinite(got).all()
    assert rel_l2(got, want) < INT8_REL and cos > INT8_COS


def _flax_leaf(params, path, leaf):
    node = params
    for k in path.split("/"):
        node = node[k]
    return node[leaf]


@pytest.mark.parametrize("quant,dtype", [("int8", torch.float32),
                                         ("int8_static", torch.float32),
                                         ("int8_all_static", torch.float32),
                                         ("int8_static", torch.bfloat16)])
def test_int8_convs_in_the_model_match_jax(qsmall, monkeypatch, quant,
                                           dtype):
    """Every int8 product of the port's forward, fed to JAX's
    ``conv3x3_int8``/``conv1x1_int8`` with the same input and that module's
    weights from the JAX tree (cast to the activations' type, as JAX's
    layers cast them): equal within one dequant rounding (f32), or in
    bf16 within one bf16 rounding.  This holds the model's dispatch to
    JAX's: which weights, bias, scale mode and clip each conv uses, and the
    cached int8 weights."""
    _, params, tmod, x, t = qsmall
    tmod = copy.deepcopy(tmod).to(dtype)
    _env(monkeypatch, "0", quant)
    calls, cur = [], []
    orig3, orig1 = tq.conv3x3_int8, tq.conv1x1_int8

    def rec3(xx, w, b=None, **kw):
        y = orig3(xx, w, b, **kw)
        calls.append(("3x3", cur[-1], xx, kw.get("act_amax"), y))
        return y

    def rec1(xx, w, b=None, **kw):
        y = orig1(xx, w, b, **kw)
        calls.append(("1x1", cur[-1], xx, kw.get("act_amax"), y))
        return y

    monkeypatch.setattr(tq, "conv3x3_int8", rec3)
    monkeypatch.setattr(tq, "conv1x1_int8", rec1)
    hooks = []
    for name, m in tmod.layers.named_modules():
        if isinstance(m, (L.PConv3x3, L.PConv1x1, L.NIN)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, p=name.replace(".", "/"): cur.append(p)))
            hooks.append(m.register_forward_hook(
                lambda mod, a, o: cur.pop() and None))
    try:
        with torch.no_grad():
            tmod(torch.from_numpy(x).to(dtype), torch.from_numpy(t))
    finally:
        for h in hooks:
            h.remove()
    n3 = sum(c[0] == "3x3" for c in calls)
    assert n3 == 10          # Conv_0/Conv_1 of the 5 resblocks
    assert (len(calls) - n3 > 0) == (quant == "int8_all_static")
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else ULP
    for kind, path, xx, amax, y in calls:
        xj = jnp.asarray(xx.float().numpy()).astype(jdt)
        if kind == "3x3":
            w = _flax_leaf(params, path, "kernel")
            b = _flax_leaf(params, path, "bias")
            want = jq.conv3x3_int8(xj, jnp.asarray(w).astype(jdt),
                                   jnp.asarray(b).astype(jdt), act_amax=amax)
        else:
            leaf = "W" if path.rsplit("/", 1)[-1].startswith("NIN") \
                else "kernel"
            w = _flax_leaf(params, path, leaf)
            b = _flax_leaf(params, path, "b" if leaf == "W" else "bias")
            want = jq.conv1x1_int8(xj, jnp.asarray(w).astype(jdt),
                                   jnp.asarray(b) if leaf == "W"
                                   else jnp.asarray(b).astype(jdt),
                                   act_amax=amax)
        want = np.asarray(want, np.float64)
        got = y.float().numpy().astype(np.float64)
        assert amax == (6.0 if quant in tq.STATIC_MODES else None), path
        lim = tol * np.maximum(np.abs(want), 1e-30) + 1e-37
        assert (np.abs(got - want) <= lim).all(), (path, kind)


@pytest.mark.parametrize("flag", ["0", "2"])
def test_ddpm_resblocks_match_jax(monkeypatch, flag):
    """``resblock_type="ddpm"`` (ResnetBlockDDPMpp, resampling by Down/Up
    modules between the blocks) unfused under ``0`` and fused under
    ``2``."""
    kw = dict(SMALL, resblock_type="ddpm")
    jm, params, tm, x, t = _build(kw, seed=7)
    _env(monkeypatch, flag, "")
    blocks = [m for m in tm.layers.values()
              if isinstance(m, L.ResnetBlockDDPMpp)]
    assert len(blocks) == 8
    meta = torch.empty(2, 8, 8, 128, device="meta")
    assert blocks[0].route(meta) == ("fused" if flag == "2" else "unfused")
    got = _port_forward(tm, x, t)
    # the reference function: JAX's unfused XLA form (its fused form is
    # the same function; Pallas in interpret mode would take 8 s here)
    _env(monkeypatch, "0", "")
    want = _jax_forward(jm, params, x, t)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < TOL


def test_ddpm_walk_names_match_jax():
    """The DDPM++ walk holds its resampling modules where JAX's does: the
    JAX tree loads (``_build``), and each block's shortcut is ``NIN_0``."""
    kw = dict(SMALL, resblock_type="ddpm")
    _, params, tm, _, _ = _build(kw, seed=8)
    for name, m in tm.layers.items():
        if isinstance(m, L.ResnetBlockDDPMpp):
            assert hasattr(m, "NIN_0") == ("NIN_0" in params[name]), name
        if isinstance(m, (L.Downsample, L.Upsample)):
            assert "Conv_0" in params[name]


def test_schedule_biases_match_jax(small):
    """``ncsnpp_schedule_biases`` on the DDPM schedule's times, f32."""
    jm, params, tm, x, t = small
    times = np.array([999.0, 642.0, 120.0, 0.0], np.float32)
    got = ncsnpp_schedule_biases(tm, torch.from_numpy(times))
    want = jax_biases(jm, params, jnp.asarray(times))
    assert sorted(got) == sorted(want) and len(got) == 10
    for k, v in got.items():
        assert tuple(v.shape) == (4, 1, tm.layers[k].GroupNorm_1.scale
                                  .shape[0])
        # sin/cos of the embedding's arguments (up to 999 x 1) differ in
        # last bits between the libraries; relative L2 as the forwards
        assert rel_l2(v.numpy(), np.asarray(want[k])) < TOL, k


@pytest.mark.parametrize("flag", ["2", "0"])
def test_forward_with_mods(small, monkeypatch, flag):
    """A forward with one step's hoisted biases equals the forward without
    (bit for bit: the same products on the same rows), and JAX's with
    ``mods``."""
    jm, params, tm, x, t = small
    _env(monkeypatch, flag, "")
    tt = np.full((2,), 420.0, np.float32)
    mods = ncsnpp_schedule_biases(tm, torch.tensor([999.0, 420.0]))
    step = {k: v[1] for k, v in mods.items()}
    got = _port_forward(tm, x, tt, mods=step)
    np.testing.assert_array_equal(got, _port_forward(tm, x, tt))
    _env(monkeypatch, "0", "")           # JAX's XLA form, as above
    jmods = jax_biases(jm, params, jnp.asarray([999.0, 420.0]))
    want = _jax_forward(jm, params, x, tt,
                        mods={k: v[1] for k, v in jmods.items()})
    assert rel_l2(got, want) < TOL


def test_mods_needs_a_conditional_model():
    kw = dict(SMALL, conditional=False)
    tm = NCSNpp(NCSNppConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="conditional"):
        ncsnpp_schedule_biases(tm, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="conditional"):
        tm(torch.zeros(1, 8, 8, 3), torch.zeros(1), mods={})
