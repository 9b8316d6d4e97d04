"""The port's DiT slice against the JAX package's at a small DiT (input 8,
patch 2, hidden 256, depth 2, 4 heads of 64, 10 classes; hidden 256 so
every ``QDense`` passes ``qmatmul_ok``), every weight random from numpy
and carried across by ``load_jax_params``: the forward with and without
the hoisted modulations, the CFG wrapper, the w8 path, 4-step CFG DDIM NI
with ``step_inputs``, the guidance combinators and the two apps."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.coeffs import registry as jax_registry
from naturaldiffusion_tpu.engine import NISchedule as JaxSchedule
from naturaldiffusion_tpu.engine import guidance as jax_guidance
from naturaldiffusion_tpu.engine import natural_inference as jax_ni
from naturaldiffusion_tpu.models import dit as jdit
from naturaldiffusion_tpu.ops.quant import quantize_weight as jax_quantize
from naturaldiffusion_tpu_torch.apps import bench_dit, validate_dit
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.engine import guidance
from naturaldiffusion_tpu_torch.models import dit
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from torch_port_util import random_flax_params, rel_l2

torch.set_num_threads(2)

CFG = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=256,
           depth=2, num_heads=4, num_classes=10)
# float32 on both sides, two blocks of sums in other orders: ~1e-6
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    jm = jdit.DiT(config=jdit.DiTConfig(**CFG))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 4), jnp.float32),
                          jnp.zeros((1,), jnp.float32),
                          jnp.zeros((1,), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    params = random_flax_params(shapes, np.random.default_rng(0))
    tm = load_jax_params(dit.DiT(dit.DiTConfig(**CFG), device="cpu"),
                         params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 420.0, 999.0, 420.0], np.float32)
    y = np.array([3, 7, 10, 10], np.int32)
    return jm, params, tm, x, t, y


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_matches_jax(pair):
    jm, params, tm, x, t, y = pair
    want = np.asarray(jm.apply({"params": params}, x, t, y))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(y).long()).numpy()
    assert got.shape == want.shape == (4, 8, 8, 8)
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < F32_TOL


def test_schedule_mods_and_forward_with_mods_match_jax(pair):
    jm, params, tm, x, t, y = pair
    t_all = np.array([999.0, 500.0, 3.0], np.float32)
    jmods = jdit.dit_schedule_mods(jm, params, jnp.asarray(t_all), y)
    with torch.no_grad():
        tmods = dit.dit_schedule_mods(tm, _t(t_all), _t(y).long())
    for a, b in zip(tmods["blocks"] + (tmods["final"],),
                    jmods["blocks"] + (jmods["final"],)):
        assert a.shape == b.shape
        assert rel_l2(a.numpy(), np.asarray(b)) < F32_TOL
    k = 1
    want = np.asarray(jm.apply(
        {"params": params}, x, t, y,
        mods=jax.tree.map(lambda a: a[k], jmods)))
    with torch.no_grad():
        got = tm(_t(x), None, None, mods={
            "blocks": tuple(m[k] for m in tmods["blocks"]),
            "final": tmods["final"][k]}).numpy()
    assert rel_l2(got, want) < F32_TOL


def test_forward_with_cfg_matches_jax(pair):
    jm, params, tm, x, t, y = pair
    want = np.asarray(jdit.forward_with_cfg(
        lambda xx, tt, yy: jm.apply({"params": params}, xx, tt, yy),
        x, t, y, 4.0, 4))
    with torch.no_grad():
        got = dit.forward_with_cfg(tm, _t(x), _t(t), _t(y).long(), 4.0,
                                   4).numpy()
    assert rel_l2(got, want) < F32_TOL
    # the quirk: eps of both halves equal, sigma passed through per half
    np.testing.assert_array_equal(got[:2, ..., :4], got[2:, ..., :4])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8_forward_matches_jax(pair, monkeypatch, dtype):
    """Under NATDIFF_QUANT=w8 (read at trace time: a fresh jit) every
    QDense of both packages runs the W8A16 product: the JAX Pallas kernel
    in interpret mode, the port's plain version.  The int8 weights are
    identical (both quantize the kernel in the compute type).  The rounding
    of activations to bf16 makes the product discontinuous: where the two
    packages' f32 activations differ in the last bits (~1e-6), some
    elements round a whole bf16 step apart (0.06 % at the first qkv, 24 %
    by the last fc2), so float32 reads 3.7e-4 relative L2, bounded at
    2e-3; bfloat16 reads 6.3e-3, as far apart as bf16 and f32 runs of one
    package (7.0e-3), bounded at 2e-2 (measured on this config)."""
    jm, params, _, x, t, y = pair
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    jx = jnp.asarray(x).astype(dtype)
    monkeypatch.setenv("NATDIFF_QUANT", "w8")
    want = np.asarray(jax.jit(lambda p, a, b, c: jm.apply(
        {"params": p}, a, b, c))(jparams, jx, t, y).astype(jnp.float32))
    tm = load_jax_params(dit.DiT(dit.DiTConfig(**CFG), device="cpu"),
                         params, dtype=getattr(torch, dtype))
    tm.set_quant("w8")
    calls = []
    real = dit.Q.matmul_wdq
    monkeypatch.setattr(dit.Q, "matmul_wdq",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = tm(_t(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype)), _t(t), _t(y).long())
    assert got.dtype == getattr(torch, dtype)
    assert len(calls) == 4 * CFG["depth"]      # qkv, proj, fc1, fc2
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    assert rel_l2(got.float().numpy(), want) < tol
    blk = tm.blocks[1]
    w_i8, s_w, _ = blk.mlp.fc1._q
    jw, js = jax_quantize(jparams["blocks_1"]["mlp"]["fc1"]["kernel"],
                          axis=-1)
    np.testing.assert_array_equal(w_i8.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js).reshape(-1))


def test_quantized_weights_follow_the_model_dtype(pair):
    """The int8 cache is remade when the weights change type or value."""
    _, params, _, x, t, y = pair
    tm = load_jax_params(dit.DiT(dit.DiTConfig(**CFG), device="cpu"),
                         params)
    tm.set_quant("w8")
    with torch.no_grad():
        tm(_t(x), _t(t), _t(y).long())
        s32 = tm.blocks[0].attn.qkv._q[1].clone()
        tm.to(torch.bfloat16)
        tm(_t(x).bfloat16(), _t(t), _t(y).long())
    s16 = tm.blocks[0].attn.qkv._q[1]
    want = quantize_weight_bf16(params["blocks_0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(s16.numpy(), want)
    assert not torch.equal(s16, s32)
    with pytest.raises(ValueError, match="quant"):
        tm.set_quant("int8")


def quantize_weight_bf16(k):
    _, s = jax_quantize(jnp.asarray(k).astype(jnp.bfloat16), axis=-1)
    return np.asarray(s).reshape(-1)


def test_cfg_ni_with_step_inputs_matches_jax(pair):
    """4-step CFG DDIM NI with the hoisted modulations riding
    ``step_inputs``, as ``apps/bench_dit.py`` runs it, in float32: the JAX
    engine (unrolled) against the port's loop with kernel K1's plain
    version.  f32 model differences (~1e-6) grow by 1/alpha in eps -> x0."""
    jm, params, tm, x, _, y = pair
    n, cin = 4, 4
    z0 = np.concatenate([x[:2], x[:2]])    # the CFG pair: equal halves
    matrix = registry.derive("ddim", n)
    jsched = JaxSchedule.from_matrix(jax_registry.derive("ddim", n))
    jmods = jdit.dit_schedule_mods(jm, params, jsched.node[:n, 0], y)

    def jfwd(zz, t, mods):
        tb = jnp.full((zz.shape[0],), t, jnp.float32)
        return jdit.forward_with_cfg(
            lambda xx, tt, yy: jm.apply({"params": params}, xx, tt, yy,
                                        mods=mods),
            zz, tb, y, 4.0, cin)[..., :cin]

    want = np.asarray(jax_ni(jfwd, jsched, jnp.asarray(z0),
                             prediction_type="eps", step_inputs=jmods))
    run = bench_dit.make_sampler(tm, matrix, cfg_scale=4.0)
    got = run(_t(z0), _t(y).long()).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    assert rel_l2(got, want) < 1e-4
    np.testing.assert_array_equal(got[:2], got[2:])


def _toy_model(x, t, c):
    return jnp.tanh(x * (1.0 + 0.1 * c[:, None, None, None])) + t


def _toy_model_torch(x, t, c):
    return torch.tanh(x * (1.0 + 0.1 * c[:, None, None, None])) + t


@pytest.mark.parametrize("split", [None, 2])
def test_guidance_matches_jax(split):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    cond = np.array([1.0, 2.0], np.float32)
    uncond = np.array([0.0, 0.0], np.float32)
    t = np.float32(0.3)
    want = jax_guidance.classifier_free(
        _toy_model, jnp.asarray(cond), jnp.asarray(uncond), 3.0,
        split_channels=split)(jnp.asarray(x), t)
    got = guidance.classifier_free(
        _toy_model_torch, _t(cond), _t(uncond), 3.0,
        split_channels=split)(_t(x), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    want2 = jax_guidance.classifier_free_two_pass(
        _toy_model, jnp.asarray(cond), jnp.asarray(uncond), 3.0)(
            jnp.asarray(x), t)
    got2 = guidance.classifier_free_two_pass(
        _toy_model_torch, _t(cond), _t(uncond), 3.0)(_t(x), torch.tensor(t))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-6,
                               atol=1e-6)
    got3 = guidance.unconditional(lambda a, b: a * b)(_t(x), 2.0)
    np.testing.assert_array_equal(got3.numpy(), 2.0 * x)


@pytest.mark.parametrize("alg", ["ddim", "ddpm"])
def test_validate_dit_passes_on_the_cpu(alg, capsys):
    assert validate_dit.main(["--small", "--steps", "4", "--alg", alg,
                              "--device", "cpu"]) == 0
    assert "[OK ]" in capsys.readouterr().out


@pytest.mark.parametrize("mods", [True, False])
def test_bench_dit_toy_on_the_cpu(mods, capsys, monkeypatch):
    monkeypatch.setenv("NATDIFF_QUANT", "w8")
    argv = ["--toy", "--steps", "2", "--device", "cpu"]
    assert bench_dit.main(argv + ([] if mods else ["--no-mods"])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["quant"] == "w8" and out["mods"] is mods
    assert out["device"] == "cpu" and out["mfu"] is None
    assert out["flops_per_fwd"] == bench_dit.flops_per_forward(
        bench_dit.TOY, 1, mods)
    assert out["sec_per_image"] > 0


def test_flops_per_forward_of_dit_xl2():
    """DiT-XL/2 at one image (model batch 2): 28 x 4 QDense products of
    445.9 M weights at 512 rows, attention 16.9 GFLOP, ~474 GFLOP in all
    (the DiT paper's 118.6 GMAC per image, times 2 images, times 2)."""
    f = bench_dit.flops_per_forward(dit.DIT_CONFIGS["DiT-XL/2"], 1, True)
    assert abs(f / 474.4e9 - 1) < 0.01


def test_load_jax_params_raises_on_a_dit_mismatch(pair):
    _, params, _, _, _, _ = pair
    model = dit.DiT(dit.DiTConfig(**CFG), device="cpu")
    missing = {k: v for k, v in params.items() if k != "final_layer"}
    with pytest.raises(KeyError, match="final_layer"):
        load_jax_params(model, missing)


def test_small_dits_are_the_jax_apps(monkeypatch):
    """``bench_dit.TOY`` and ``validate_dit.SMALL`` are the JAX apps' small
    DiTs (2 heads of 32, 4 heads of 16), and kernel K9 takes their head
    dims."""
    import argparse
    from naturaldiffusion_tpu.apps import bench_dit as jax_bench_dit
    from naturaldiffusion_tpu.apps import validate_dit as jax_validate_dit
    from naturaldiffusion_tpu_torch.ops.attention import _HEAD_DIMS
    seen = []

    class Built(Exception):
        pass

    def record(config):         # the app's model, recorded, then stop
        seen.append(config)
        raise Built
    monkeypatch.setattr(jax_bench_dit, "DiT", record)
    with pytest.raises(Built):
        jax_bench_dit.main(["--toy", "--flops-only"])
    monkeypatch.setattr(jax_validate_dit, "DiT", record)
    with pytest.raises(Built):
        jax_validate_dit.build_model(argparse.Namespace(
            small=True, model="DiT-XL/2", ckpt=None))
    small = seen[1]
    fields = ("input_size", "patch_size", "in_channels", "hidden_size",
              "depth", "num_heads", "num_classes")
    for mine, ref in ((bench_dit.TOY, seen[0]), (validate_dit.SMALL, small)):
        assert [getattr(mine, f) for f in fields] == [getattr(ref, f)
                                                      for f in fields]
        assert mine.hidden_size // mine.num_heads in _HEAD_DIMS
    assert bench_dit.TOY.hidden_size // bench_dit.TOY.num_heads == 32
    assert validate_dit.SMALL.hidden_size // validate_dit.SMALL.num_heads == 16


# bf16 params and inputs, port against JAX: the measured control is the
# distance of JAX's bf16 forward from its f32 forward on the same weights
# (7.3e-3 relative L2).  JAX's attention on the CPU runs its "xla" branch
# in bf16, the port's in f32 (kernel K9's plain version), and sums run in
# other orders, so the two bf16 runs each lie about the control from f32
# and up to sqrt(2) x the control from each other (measured: 0.85x the
# control from JAX's bf16 run, 0.96x from its f32 run).  Bound at 1.5x the
# control, against both; a wrong layer moves the output by O(1)
BF16_CONTROL_FACTOR = 1.5


def test_bf16_forward_matches_jax(pair):
    jm, params, _, x, t, y = pair
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 params)
    want32 = np.asarray(jm.apply({"params": params}, x, t, y), np.float32)
    want16 = np.asarray(jm.apply({"params": p16}, jnp.asarray(x, jnp.bfloat16),
                                 t, y), np.float32)
    tm = load_jax_params(dit.DiT(dit.DiTConfig(**CFG), device="cpu"),
                         params, dtype=torch.bfloat16)
    with torch.no_grad():
        got16 = tm(_t(x).bfloat16(), _t(t), _t(y).long()).float().numpy()
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 5e-2
    assert np.isfinite(got16).all()
    assert rel_l2(got16, want16) <= BF16_CONTROL_FACTOR * control
    assert rel_l2(got16, want32) <= BF16_CONTROL_FACTOR * control
