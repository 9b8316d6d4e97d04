"""Every BigGAN resblock of a full-width walk takes the form the JAX package
gives it: fused (K3), fused after the resampling, or unfused with the
whole-image conv (K2) or the halo-tiled one (K4).  Shapes only, no
forward: the JAX side is traced abstractly (``jax.eval_shape`` of its bf16
forward under ``NATDIFF_PALLAS_CONV=2``) with its conv functions replaced
by recorders; the port side asks its own predicates for the same blocks."""

import jax
import jax.numpy as jnp
import torch
from flax.linen import module as flax_module

from naturaldiffusion_tpu.configs import get_config as jax_get_config
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import (
    CIFAR10_DDPMPP_CONTINUOUS as JAX_CIFAR)
from naturaldiffusion_tpu.ops import conv3x3 as jconv
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch.models import layers as L
from naturaldiffusion_tpu_torch.models.ncsnpp import (
    CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)
from naturaldiffusion_tpu_torch.ops import conv3x3 as tconv
import torch_port_util  # noqa: F401  binds torch's CPU math first

CELEBAHQ = "ve/celebahq_256_ncsnpp_continuous"


def _jax_walk(cfg, monkeypatch, batch=4):
    """{block name: (input shape, up, down, out_ch, {conv: kernel})} from an
    abstract trace of the JAX model's bf16 forward."""
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    blocks, convs = {}, {}

    def here():
        return flax_module._context.module_stack[-1]

    ok = jconv.fused_resblock_ok

    def rec_ok(x, out_ch, *, shape=None):
        m = here()
        blocks.setdefault(m.path[0], (tuple(x.shape), m.up, m.down, out_ch))
        return ok(x, out_ch, shape=shape)

    def rec(kind):
        def fn(x, w, b=None, *, emit_stats=False, variant=None, **kw):
            path = here().path
            if len(path) == 2:      # a block's conv, not the stem or head
                convs.setdefault(path[0], {})[path[1]] = (
                    {"tiled": "K4", "tiledew": "K4"}.get(variant, "K2")
                    if kind == "pallas" else kind)
            y = jnp.zeros(x.shape[:3] + (w.shape[-1],), x.dtype)
            if emit_stats:
                s = jnp.zeros((x.shape[0], w.shape[-1]), jnp.float32)
                return y, s, s
            return y
        return fn

    monkeypatch.setattr(jconv, "fused_resblock_ok", rec_ok)
    monkeypatch.setattr(jconv, "conv3x3_gn_pallas", rec("K3"))
    monkeypatch.setattr(jconv, "conv3x3_pallas", rec("pallas"))
    monkeypatch.setattr(jconv, "conv3x3_xla", rec("XLA"))
    jm = JaxNCSNpp(config=cfg)
    n = cfg.image_size
    with jax.enable_x64(False):
        x = jax.ShapeDtypeStruct((batch, n, n, 3), jnp.bfloat16)
        t = jax.ShapeDtypeStruct((batch,), jnp.float32)
        shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(x.shape),
                                                  jnp.ones(t.shape)),
                                jax.random.PRNGKey(0))["params"]
        bf = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16), shapes)
        blocks.clear()
        convs.clear()
        jax.eval_shape(lambda p, a, b: jm.apply({"params": p}, a, b), bf, x,
                       t)
    return {k: v + (convs[k],) for k, v in blocks.items()}


def _port_route(blk, shape):
    """(form, {conv: kernel}) of a port resblock for an input of ``shape``
    in bf16, from the port's own predicates."""
    meta = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    form = blk.route(meta)
    if form != "unfused":
        return form, {"Conv_0": "K3", "Conv_1": "K3"}
    b, h, w, c = shape
    h, w = (2 * h, 2 * w) if blk.up else (h // 2, w // 2) if blk.down \
        else (h, w)
    k = {}
    for name, cin in (("Conv_0", c), ("Conv_1", blk.out_ch)):
        x = torch.empty((b, h, w, cin), dtype=torch.bfloat16, device="meta")
        k[name] = "K4" if tconv.large_map(x, blk.out_ch) else "K2"
    return form, k


def _check_walk(port_model, jax_blocks):
    port_blocks = {k: m for k, m in port_model.layers.items()
                   if isinstance(m, L.ResnetBlockBigGANpp)}
    assert sorted(port_blocks) == sorted(jax_blocks)
    table = []
    for name, (shape, up, down, out_ch, jconvs) in jax_blocks.items():
        blk = port_blocks[name]
        assert (blk.up, blk.down, blk.out_ch) == (up, down, out_ch), name
        assert set(jconvs.values()) <= {"K2", "K3", "K4"}, (name, jconvs)
        jform = ("unfused" if jconvs["Conv_1"] != "K3"
                 else "resample_fused" if up or down else "fused")
        form, kernels = _port_route(blk, shape)
        assert (form, kernels) == (jform, {c: jconvs[c] for c in kernels}), \
            (name, shape, form, kernels, jform, jconvs)
        hw = shape[1] * 2 if up else shape[1] // 2 if down else shape[1]
        table.append((hw, shape[3], out_ch, form, kernels))
    return table


def test_celebahq_256_routes_match_jax(monkeypatch):
    """The table of the slice, by the map the block's convs run at: at
    256^2 and 128^2 unfused through K4; at 64^2 unfused (the 128 -> 256
    conv through K2, the others through K4), apart from the down block
    from 128^2, which fuses after its resampling; at 16^2 and below
    fused."""
    table = _check_walk(
        NCSNpp(configs.get_config(CELEBAHQ).model, device="cpu"),
        _jax_walk(jax_get_config(CELEBAHQ).model, monkeypatch))
    assert len(table) == 49
    for hw, cin, cout, form, k in table:
        if hw == 64 and (cin, cout) == (128, 128):
            assert form == "resample_fused"
        elif hw >= 64:
            assert form == "unfused", (hw, cin, cout)
            assert k["Conv_1"] == "K4"
            assert k["Conv_0"] == ("K2" if (hw, cin, cout) == (64, 128, 256)
                                   else "K4")
        elif hw <= 16:
            assert form in ("fused", "resample_fused"), (hw, cin, cout)
    assert (64, 128, 256, "unfused", {"Conv_0": "K2", "Conv_1": "K4"}) in \
        table


def test_cifar_routes_match_jax(monkeypatch):
    """The CIFAR-10 walk stays wholly fused: 88 K3 launches per forward."""
    table = _check_walk(NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu"),
                        _jax_walk(JAX_CIFAR, monkeypatch, batch=64))
    assert len(table) == 44
    assert all(form != "unfused" for *_, form, _ in table)
