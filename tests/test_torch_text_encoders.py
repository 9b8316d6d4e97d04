"""The port's SD3 text encoders against the JAX package's: small CLIP
encoders (``quick_gelu`` as CLIP-L, ``gelu`` as bigG; both pooling rules)
and a small T5 encoder, every weight random from numpy and carried across
by ``load_jax_params``; T5's bucket table; ``sd3_encode_prompt`` with and
without T5 (the zero T5 block); and the converters on state dicts in the
HF names."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models import text_encoders as jt
from naturaldiffusion_tpu.models.convert import fill_from_torch as jfill
from naturaldiffusion_tpu_torch.models import text_encoders as tt
from naturaldiffusion_tpu_torch.models.convert import (fill_from_torch,
                                                       load_jax_params)
from torch_port_util import jax_params, rel_l2, torch_state_dict

torch.set_num_threads(2)

F32_TOL = 1e-5
CLIP = dict(vocab_size=60, hidden_size=32, num_layers=3, num_heads=4,
            intermediate_size=48, max_positions=12, projection_dim=24)
T5 = dict(vocab_size=50, d_model=32, d_kv=8, d_ff=48, num_layers=2,
          num_heads=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(shape, high, seed):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


def _clip(act, eos=2):
    cfg = dict(CLIP, hidden_act=act, eos_token_id=eos)
    jmod = jt.CLIPTextEncoder(config=jt.CLIPTextConfig(**cfg))
    params = jax_params(jmod, _ids((1, 12), 60, 0))
    tmod = load_jax_params(tt.CLIPTextEncoder(tt.CLIPTextConfig(**cfg),
                                              device="cpu"), params)
    return jmod, params, tmod


def _t5(**over):
    cfg = dict(T5, **over)
    jmod = jt.T5Encoder(config=jt.T5Config(**cfg))
    params = jax_params(jmod, _ids((1, 20), 50, 0))
    tmod = load_jax_params(tt.T5Encoder(tt.T5Config(**cfg), device="cpu"),
                           params)
    return jmod, params, tmod


def test_configs_are_jax():
    for name in ("CLIP_L_SD3", "CLIP_G_SD3", "T5_XXL"):
        assert dataclasses.asdict(getattr(tt, name)) == dataclasses.asdict(
            getattr(jt, name))


@pytest.mark.parametrize("act,eos", [("quick_gelu", 2), ("gelu", 2),
                                     ("gelu", 7)])
def test_clip_matches_jax(act, eos):
    """Penultimate hidden state and projected pooled output; ``eos == 2``
    pools at the highest id, another ``eos`` at its first position."""
    jmod, params, tmod = _clip(act, eos)
    ids = _ids((3, 12), 60, 1)
    ids[:, 5] = 7                     # an eos 7 in every row, not the max
    ids[2, 9] = 7
    penult, pooled = jmod.apply({"params": params}, ids)
    with torch.no_grad():
        tpen, tpool = tmod(_t(ids).long())
    assert tpen.shape == (3, 12, 32) and tpool.shape == (3, 24)
    assert rel_l2(tpen.numpy(), np.asarray(penult)) < F32_TOL
    assert rel_l2(tpool.numpy(), np.asarray(pooled)) < F32_TOL


def test_clip_penultimate_is_the_last_layers_input():
    """The context output is the state before the last layer: a change to
    the last layer's weights moves the pooled output only."""
    _, _, tmod = _clip("quick_gelu")
    ids = _t(_ids((2, 12), 60, 2)).long()
    with torch.no_grad():
        pen0, pool0 = tmod(ids)
        tmod.layers_2.mlp_fc2.kernel.mul_(3.0)
        pen1, pool1 = tmod(ids)
    torch.testing.assert_close(pen0, pen1, rtol=0, atol=0)
    assert rel_l2(pool1.numpy(), pool0.numpy()) > 1e-2


def test_t5_matches_jax():
    jmod, params, tmod = _t5()
    ids = _ids((2, 20), 50, 3)
    want = np.asarray(jmod.apply({"params": params}, ids))
    with torch.no_grad():
        got = tmod(_t(ids).long()).numpy()
    assert got.shape == (2, 20, 32)
    assert rel_l2(got, want) < F32_TOL


@pytest.mark.parametrize("t", [1, 7, 77, 256, 333])
def test_t5_relative_buckets_equal_jax(t):
    for nb, md in ((32, 128), (8, 20)):
        np.testing.assert_array_equal(tt.t5_relative_buckets(t, nb, md),
                                      jt.t5_relative_buckets(t, nb, md))


@pytest.mark.parametrize("with_t5", [True, False])
def test_sd3_encode_prompt_matches_jax(with_t5):
    """CLIP-L and CLIP-G penultimate states concatenated, zero-padded to
    ``joint_dim``; the T5 states after them, or a zero block of
    ``max_sequence_length`` tokens."""
    jl, pl, tl = _clip("quick_gelu")
    g_cfg = dict(CLIP, hidden_act="gelu", hidden_size=40, num_heads=5,
                 projection_dim=16)
    jg = jt.CLIPTextEncoder(config=jt.CLIPTextConfig(**g_cfg))
    pg = jax_params(jg, _ids((1, 12), 60, 0), seed=1)
    tg = load_jax_params(tt.CLIPTextEncoder(tt.CLIPTextConfig(**g_cfg),
                                            device="cpu"), pg)
    ids_l, ids_g = _ids((2, 12), 60, 4), _ids((2, 12), 60, 5)
    j5 = p5 = t5m = ids5 = None
    if with_t5:
        j5, p5, t5m = _t5(d_model=96)
        ids5 = _ids((2, 20), 50, 6)
    want, wpool = jt.sd3_encode_prompt(jl, pl, ids_l, jg, pg, ids_g, j5, p5,
                                       ids5, joint_dim=96,
                                       max_sequence_length=9)
    with torch.no_grad():
        got, gpool = tt.sd3_encode_prompt(
            tl, _t(ids_l).long(), tg, _t(ids_g).long(), t5m,
            None if ids5 is None else _t(ids5).long(), joint_dim=96,
            max_sequence_length=9)
    t_ctx = 12 + (20 if with_t5 else 9)
    assert got.shape == want.shape == (2, t_ctx, 96)
    assert gpool.shape == wpool.shape == (2, 24 + 16)
    assert rel_l2(got.numpy(), np.asarray(want)) < F32_TOL
    assert rel_l2(gpool.numpy(), np.asarray(wpool)) < F32_TOL
    assert not got[:, :12, 72:].any()                 # the CLIP pad
    if not with_t5:
        assert not got[:, 12:].any()                  # the zero T5 block
    with pytest.raises(ValueError, match="joint_dim"):
        tt.sd3_encode_prompt(tl, _t(ids_l).long(), tg, _t(ids_g).long(),
                             joint_dim=64)


@pytest.mark.parametrize("which", ["clip", "t5"])
def test_fill_from_torch_matches_jax_converter(which):
    """A state dict in the HF names (``CLIPTextModelWithProjection``,
    ``T5EncoderModel``) through both converters: the same parameters."""
    if which == "clip":
        jmod, params, tmod = _clip("gelu")
        jmap, tmap = jt.clip_torch_path_map, tt.clip_torch_path_map
    else:
        jmod, params, tmod = _t5()
        jmap, tmap = jt.t5_torch_path_map, tt.t5_torch_path_map
    sd = torch_state_dict(params, jmap, np.random.default_rng(9))
    want, junused = jfill(params, sd, path_map=jmap)
    unused = fill_from_torch(tmod, sd, path_map=tmap)
    assert unused == junused == ["sigmas"]
    flat = {".".join(k.key for k in kp): np.asarray(leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    own = dict(tmod.named_parameters())
    assert own.keys() == flat.keys()
    for name, prm in own.items():
        np.testing.assert_array_equal(prm.detach().numpy(), flat[name])
        path = tuple(name.split("."))[:-1]
        assert tmap(path) == jmap(path)
