"""The port's MMDiT against the JAX package's at a small MMDiT (hidden 64,
depth 2, 4 heads of 16, patch 2, joint_dim 32, pooled 16, pos-embed table
16), with and without ``qk_norm``, on a 6 x 10 latent (an uneven crop of
the table), every weight random from numpy and carried across by
``load_jax_params``: the forward, the hoisted modulations, the CFG
predictor, bf16 against JAX's bf16-vs-f32 control, the cropped positions,
the per-stream LayerNorm against JAX's fused one, the converter on the
torch twin's state dict, and a ``token_constraint`` that is no sharding
refused."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models import mmdit as jm
from naturaldiffusion_tpu.models.convert import fill_from_torch as jfill
from naturaldiffusion_tpu_torch import models
from naturaldiffusion_tpu_torch.models import mmdit as tm
from naturaldiffusion_tpu_torch.models.convert import (fill_from_torch,
                                                       load_jax_params)
from torch_port_util import jax_params, rel_l2

torch.set_num_threads(2)

CFG = dict(sample_size=8, patch_size=2, in_channels=4, hidden_size=64,
           depth=2, num_heads=4, caption_projection_dim=64,
           joint_attention_dim=32, pooled_projection_dim=16,
           pos_embed_max_size=16)
# float32 on both sides, sums in other orders: ~1e-6
F32_TOL = 1e-5
# see tests/test_torch_dit.py: bf16 runs of the two packages each lie about
# the control from f32, up to sqrt(2) x the control from each other
BF16_CONTROL_FACTOR = 1.5


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 10, 4)).astype(np.float32)
    t = np.array([980.0, 310.0], np.float32)
    ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    return x, t, ctx, pooled


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "qk_norm"])
def pair(request):
    cfg = dict(CFG, qk_norm=request.param)
    jmod = jm.MMDiT(config=jm.MMDiTConfig(**cfg))
    x, t, ctx, pooled = _inputs()
    params = jax_params(jmod, x[:1], t[:1], ctx[:1], pooled[:1])
    tmod = load_jax_params(tm.MMDiT(tm.MMDiTConfig(**cfg), device="cpu"),
                           params)
    return jmod, params, tmod


def test_forward_matches_jax(pair):
    jmod, params, tmod = pair
    x, t, ctx, pooled = _inputs()
    want = np.asarray(jmod.apply({"params": params}, x, t, ctx, pooled))
    with torch.no_grad():
        got = tmod(_t(x), _t(t), _t(ctx), _t(pooled)).numpy()
    assert got.shape == want.shape == (2, 6, 10, 4)
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < F32_TOL


@pytest.mark.parametrize("fused", ["0", "1"])
def test_per_stream_layer_norm_is_jax_fused_one(pair, monkeypatch, fused):
    """JAX's ``ln_pair`` (one LayerNorm over the concatenated streams under
    ``NATDIFF_MMDIT_FUSED_LN=1``, two under ``0``, read per call) gives the
    forward the port computes with one LayerNorm per stream."""
    jmod, params, tmod = pair
    x, t, ctx, pooled = _inputs(2)
    monkeypatch.setenv("NATDIFF_MMDIT_FUSED_LN", fused)
    want = np.asarray(jmod.apply({"params": params}, x, t, ctx, pooled))
    with torch.no_grad():
        got = tmod(_t(x), _t(t), _t(ctx), _t(pooled)).numpy()
    assert rel_l2(got, want) < F32_TOL


def test_ln_pair_equals_one_layer_norm_over_the_concatenation():
    import flax.linen as nn
    rng = np.random.default_rng(3)
    a = (3.0 * rng.standard_normal((2, 7, 64)) + 1.0).astype(np.float32)
    b = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ln = nn.LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)
    joint = np.asarray(ln.apply({}, jnp.concatenate([a, b], axis=1)))
    la, lb = tm.ln_pair(_t(a), _t(b))
    np.testing.assert_allclose(la.numpy(), joint[:, :7], atol=2e-6, rtol=0)
    np.testing.assert_allclose(lb.numpy(), joint[:, 7:], atol=2e-6, rtol=0)


def test_schedule_mods_and_forward_with_mods_match_jax(pair):
    jmod, params, tmod = pair
    x, _, ctx, pooled = _inputs()
    t_all = np.array([1000.0, 640.5, 12.0], np.float32)
    jmods = jm.mmdit_schedule_mods(jmod, params, jnp.asarray(t_all),
                                   jnp.asarray(pooled), jnp.asarray(ctx))
    tmods = tm.mmdit_schedule_mods(tmod, _t(t_all), _t(pooled), _t(ctx))
    pairs = [(tmods["out"], jmods["out"]), (tmods["ctx_emb"],
                                            jmods["ctx_emb"])]
    for (ax, ac), (bx, bc) in zip(tmods["blocks"], jmods["blocks"]):
        pairs += [(ax, bx), (ac, bc)]
    for a, b in pairs:
        assert a.shape == b.shape
        assert rel_l2(a.numpy(), np.asarray(b)) < F32_TOL
    # the last block's context stream has 2 modulation vectors, not 6
    assert tmods["blocks"][-1][1].shape == (3, 2, 2 * 64)
    k = 1
    jstep = dict(jax.tree.map(lambda a: a[k], {
        "blocks": jmods["blocks"], "out": jmods["out"]}),
        ctx_emb=jmods["ctx_emb"])
    want = np.asarray(jmod.apply({"params": params}, x, None, None, None,
                                 mods=jstep))
    tstep = {"blocks": tuple((mx[k], mc[k]) for mx, mc in tmods["blocks"]),
             "out": tmods["out"][k], "ctx_emb": tmods["ctx_emb"]}
    with torch.no_grad():
        got = tmod(_t(x), None, None, None, mods=tstep).numpy()
    assert rel_l2(got, want) < F32_TOL


def test_cfg_fwd_mods_matches_jax(pair):
    """``mmdit_cfg_fwd_mods``: the CFG-doubled call on the hoisted path,
    ``null + 7 (text - null)``, at step 2 of a 3-step schedule."""
    jmod, params, tmod = pair
    x, _, ctx, pooled = _inputs(4)
    ctx2 = np.concatenate([ctx, 0.0 * ctx])
    pool2 = np.concatenate([pooled, 0.5 * pooled])
    t_all = np.array([1000.0, 500.0, 3.0], np.float32)
    jfwd, jaux = jm.mmdit_cfg_fwd_mods(jmod, params, ctx2=jnp.asarray(ctx2),
                                       pool2=jnp.asarray(pool2),
                                       t_all=jnp.asarray(t_all))
    want = np.asarray(jfwd(jnp.asarray(x), t_all[2],
                           jax.tree.map(lambda a: a[2], jaux)))
    tfwd, taux = tm.mmdit_cfg_fwd_mods(tmod, ctx2=_t(ctx2), pool2=_t(pool2),
                                       t_all=_t(t_all))
    with torch.no_grad():
        got = tfwd(_t(x), torch.tensor(t_all[2]), {
            "blocks": tuple((a[2], c[2]) for a, c in taux["blocks"]),
            "out": taux["out"][2]}).numpy()
    assert got.shape == x.shape
    assert rel_l2(got, want) < F32_TOL


def test_bf16_forward_matches_jax(pair):
    jmod, params, _ = pair
    x, t, ctx, pooled = _inputs()
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want32 = np.asarray(jmod.apply({"params": params}, x, t, ctx, pooled))
    want16 = np.asarray(jmod.apply(
        {"params": p16}, jnp.asarray(x, jnp.bfloat16), t, ctx, pooled),
        np.float32)
    cfg = tm.MMDiTConfig(**dict(CFG, qk_norm=pair[2].config.qk_norm))
    tmod16 = load_jax_params(tm.MMDiT(cfg, device="cpu"), params,
                             dtype=torch.bfloat16)
    with torch.no_grad():
        got16 = tmod16(_t(x).bfloat16(), _t(t), _t(ctx),
                       _t(pooled)).float().numpy()
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 5e-2
    assert np.isfinite(got16).all()
    assert rel_l2(got16, want16) <= BF16_CONTROL_FACTOR * control
    assert rel_l2(got16, want32) <= BF16_CONTROL_FACTOR * control


@pytest.mark.parametrize("grid", [(3, 5), (4, 4), (8, 8), (1, 7)])
def test_cropped_pos_embed_equals_jax(grid):
    gh, gw = grid
    for max_size, base in ((16, 4), (192, 64), (9, 2)):
        np.testing.assert_array_equal(
            tm.sd3_cropped_pos_embed(64, gh, gw, max_size, base),
            jm.sd3_cropped_pos_embed(64, gh, gw, max_size, base))


def test_token_constraint_is_refused():
    """The hook takes a sharding (``parallel.NamedSharding``; the 4-rank
    tests run it); anything else is refused."""
    with pytest.raises(TypeError, match="NamedSharding"):
        tm.MMDiT(tm.MMDiTConfig(**CFG), device="cpu", token_constraint=1)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_fill_from_torch_matches_jax_converter(qk_norm):
    """The torch twin's state dict (diffusers' names) through the port's
    ``fill_from_torch`` and JAX's give the same parameters, and the port's
    path map is JAX's on every parameter."""
    from torch_mmdit_twin import TorchMMDiT
    torch.manual_seed(5)
    cfg = dict(CFG, qk_norm=qk_norm, pos_embed_max_size=8)
    twin = TorchMMDiT(sample_size=8, patch=2, cin=4, dim=64, depth=2,
                      heads=4, ctx_dim=32, pooled_dim=16, max_size=8,
                      qk_norm=qk_norm)
    sd = twin.state_dict()
    x, t, ctx, pooled = _inputs()
    jmod = jm.MMDiT(config=jm.MMDiTConfig(**cfg))
    want, junused = jfill(jax_params(jmod, x[:1], t[:1], ctx[:1],
                                     pooled[:1]), sd,
                          path_map=jm.mmdit_torch_path_map)
    port = tm.MMDiT(tm.MMDiTConfig(**cfg), device="cpu")
    unused = fill_from_torch(port, sd, path_map=tm.mmdit_torch_path_map)
    assert unused == junused == []
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        flat[".".join(k.key for k in kp)] = np.asarray(leaf)
    own = dict(port.named_parameters())
    assert own.keys() == flat.keys()
    for name, prm in own.items():
        np.testing.assert_array_equal(prm.detach().numpy(), flat[name])
        path = tuple(name.split("."))[:-1]
        assert tm.mmdit_torch_path_map(path) == jm.mmdit_torch_path_map(path)


def test_create_model_builds_the_mmdit():
    net = models.create_model("mmdit", device="cpu", **CFG)
    assert isinstance(net, models.MMDiT)
    assert net.config == tm.MMDiTConfig(**CFG)
    assert models.SD3_MEDIUM == tm.MMDiTConfig() and dataclasses.asdict(
        models.SD3_MEDIUM) == dataclasses.asdict(jm.SD3_MEDIUM)
