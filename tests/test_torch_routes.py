"""Every BigGAN resblock of a full-width walk takes the form the JAX package
gives it: fused (K3), fused after the resampling, or unfused with the
whole-image conv (K2) or the halo-tiled one (K4).  Shapes only, no
forward: the JAX side is traced abstractly (``jax.eval_shape`` of its bf16
forward under ``NATDIFF_PALLAS_CONV=2``) with its conv functions replaced
by recorders; the port side asks its own predicates for the same blocks.

Then every conv of the CIFAR and CelebA-HQ 256 walks under each value of
the route switch (``NATDIFF_PALLAS_CONV``, ``NATDIFF_CONV_TILED``,
``NATDIFF_CONV_VARIANT``) and each ``NATDIFF_QUANT`` mode: the port's
forward runs on meta tensors with its conv functions replaced by
recorders, and each 3x3 conv must take the implementation the JAX trace
records for it (fused K3, int8, K2, K4, library/XLA), each 1x1 product
the int8 path exactly where JAX's does.  Two departures are the port's
own (``ops/conv3x3.py``): under ``1``/``2`` K2 takes the 3-channel stem
and head and K4 the large maps that neither JAX kernel fits, where JAX
runs XLA."""

import functools

import jax
import jax.numpy as jnp
import torch
from flax.linen import module as flax_module

from naturaldiffusion_tpu.configs import get_config as jax_get_config
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import (
    CIFAR10_DDPMPP_CONTINUOUS as JAX_CIFAR)
from naturaldiffusion_tpu.ops import conv3x3 as jconv
from naturaldiffusion_tpu.ops import quant as jquant
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch.models import layers as L
from naturaldiffusion_tpu_torch.models.ncsnpp import (
    CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)
from naturaldiffusion_tpu_torch.ops import conv3x3 as tconv
from naturaldiffusion_tpu_torch.ops import group_norm as tgn
from naturaldiffusion_tpu_torch.ops import quant as tquant
import pytest
import torch_port_util  # noqa: F401  binds torch's CPU math first

CELEBAHQ = "ve/celebahq_256_ncsnpp_continuous"
BATCH = {"cifar": 64, "celebahq": 4}


@functools.lru_cache(maxsize=None)
def _jax_abstract(walk):
    """(model, bf16 param shapes, x, t) of a walk's JAX model, traced once:
    the param tree is the same under every switch (the fused and unfused
    forms share their submodule names)."""
    cfg = JAX_CIFAR if walk == "cifar" else jax_get_config(CELEBAHQ).model
    jm = JaxNCSNpp(config=cfg)
    n, batch = cfg.image_size, BATCH[walk]
    with jax.enable_x64(False):
        x = jax.ShapeDtypeStruct((batch, n, n, 3), jnp.bfloat16)
        t = jax.ShapeDtypeStruct((batch,), jnp.float32)
        shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros(x.shape),
                                                  jnp.ones(t.shape)),
                                jax.random.PRNGKey(0))["params"]
    bf = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16), shapes)
    return jm, bf, x, t


def _jax_apply(walk):
    jm, bf, x, t = _jax_abstract(walk)
    with jax.enable_x64(False):
        jax.eval_shape(lambda p, a, b: jm.apply({"params": p}, a, b), bf, x,
                       t)


def _jax_walk(walk, monkeypatch):
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
    _jax_apply(walk)
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
        _jax_walk("celebahq", monkeypatch))
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
                        _jax_walk("cifar", monkeypatch))
    assert len(table) == 44
    assert all(form != "unfused" for *_, form, _ in table)


def _jax_convs(walk, monkeypatch):
    """{module path: implementation} of every 3x3 conv (``K3``, ``int8``,
    ``K2``, ``K4``, ``XLA``) and every int8 1x1 product (``int8_1x1``) of
    an abstract trace of the JAX model's bf16 forward, under the
    environment the caller set."""
    impl = {}

    def here():
        return "/".join(flax_module._context.module_stack[-1].path)

    def rec(kind, one_by_one=False):
        def fn(x, w, b=None, *, emit_stats=False, variant=None, **kw):
            impl[here()] = ({"tiled": "K4", "tiledew": "K4"}.get(
                variant, "K2") if kind == "pallas" else kind)
            y = jnp.zeros(x.shape[:-1] + (w.shape[-1],), x.dtype)
            if emit_stats:
                s = jnp.zeros((x.shape[0], w.shape[-1]), jnp.float32)
                return y, s, s
            return y
        return fn

    monkeypatch.setattr(jconv, "conv3x3_gn_pallas", rec("K3"))
    monkeypatch.setattr(jconv, "conv3x3_pallas", rec("pallas"))
    monkeypatch.setattr(jconv, "conv3x3_xla", rec("XLA"))
    monkeypatch.setattr(jquant, "conv3x3_int8", rec("int8"))
    monkeypatch.setattr(jquant, "conv1x1_int8", rec("int8_1x1"))
    _jax_apply(walk)
    return impl


def _port_convs(model, batch, n, monkeypatch):
    """The same record of the port model's forward on meta tensors, the
    conv functions (and K6, whose launch needs real memory) replaced by
    recorders; the model's own code picks every route."""
    impl, cur = {}, []

    def rec(kind):
        def fn(x, w=None, b=None, *, emit_stats=False, **kw):
            cout = (kw["w_i8"].shape[-1] if w is None and "w_i8" in kw
                    else kw["w_q"][0].shape[-1] if w is None else w.shape[-1])
            impl[cur[-1]] = kind
            y = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype,
                            device=x.device)
            if emit_stats:
                s = torch.empty((x.shape[0], cout), dtype=torch.float32,
                                device=x.device)
                return y, s, s
            return y
        return fn

    monkeypatch.setattr(tconv, "conv3x3_gn", rec("K3"))
    monkeypatch.setattr(tconv, "conv3x3", rec("K2"))
    monkeypatch.setattr(tconv, "conv3x3_tiled", rec("K4"))
    monkeypatch.setattr(tconv, "conv3x3_library", rec("XLA"))
    monkeypatch.setattr(tquant, "conv3x3_int8", rec("int8"))
    monkeypatch.setattr(tquant, "conv1x1_int8", rec("int8_1x1"))
    monkeypatch.setattr(tgn, "fused_group_norm",
                        lambda x, *a, **k: torch.empty_like(x))
    hooks = []
    for name, m in model.layers.named_modules():
        if isinstance(m, (L.PConv3x3, L.PConv1x1, L.NIN)):
            path = name.replace(".", "/")
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, p=path: cur.append(p)))
            hooks.append(m.register_forward_hook(
                lambda mod, a, o: cur.pop() and None))
    x = torch.empty((batch, n, n, 3), dtype=torch.bfloat16, device="meta")
    t = torch.empty((batch,), device="meta")
    with torch.no_grad():
        model(x, t)
    for h in hooks:
        h.remove()
    return impl


def _want_port(jimpl, flag, path, model):
    """The port's implementation for JAX's, its two departures applied."""
    if jimpl != "XLA" or flag == "0":
        return jimpl
    conv = model.layers.get_submodule(path.replace("/", "."))
    aligned = conv.kernel.shape[2] % 128 == 0 and conv.kernel.shape[3] % 128 == 0
    return "K4" if aligned else "K2"


@pytest.fixture(scope="module")
def walks():
    """The two full-width port models on meta tensors, bf16."""
    return {"cifar": NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu").to(
                device="meta", dtype=torch.bfloat16),
            "celebahq": NCSNpp(configs.get_config(CELEBAHQ).model,
                               device="cpu").to(device="meta",
                                                dtype=torch.bfloat16)}


@pytest.mark.parametrize("walk,flag,tiled,quant,variant", [
    ("cifar", "1", "tiled", "", None),
    ("cifar", "0", "tiled", "", None),
    ("cifar", "0", "tiled", "int8_all_static", None),
    ("cifar", "2", "tiled", "int8_all", None),
    ("celebahq", "1", "tiled", "", None),
    ("celebahq", "1", "tiledew", "", "valid9"),
    ("celebahq", "0", "tiled", "int8_static", None),
    ("celebahq", "2", "tiledew", "int8_all", None),
])
def test_every_conv_routes_as_jax(walks, monkeypatch, walk, flag, tiled,
                                  quant, variant):
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", flag)
    monkeypatch.setenv("NATDIFF_CONV_TILED", tiled)
    for k, v in (("NATDIFF_QUANT", quant), ("NATDIFF_CONV_VARIANT", variant)):
        if v:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    with monkeypatch.context() as mp:
        want = _jax_convs(walk, mp)
    model = walks[walk]
    n = model.config.image_size
    with monkeypatch.context() as mp:
        got = _port_convs(model, BATCH[walk], n, mp)
    assert sorted(got) == sorted(want)
    wrong = {p: (got[p], j) for p, j in want.items()
             if got[p] != _want_port(j, flag, p, model)}
    assert not wrong, wrong
    kinds = set(got.values())
    # what each switch leaves on the walk
    if flag == "0":
        assert not kinds & {"K2", "K3", "K4"}
    if quant and flag != "2":
        assert "int8" in kinds
    assert ("int8_1x1" in kinds) == (quant in ("int8_all", "int8_all_static"))
    if flag == "2" and not quant and walk == "cifar":
        assert kinds == {"K3", "K2"}


@pytest.mark.parametrize("flag", [None, "0", "1", "2", "x"])
@pytest.mark.parametrize("tiled", [None, "tiled", "tiledew"])
def test_switch_reads_the_jax_variables(monkeypatch, flag, tiled):
    """The port's switch functions read JAX's variables with JAX's values;
    one default differs: with ``NATDIFF_PALLAS_CONV`` unset the port runs
    its main path (``2``), JAX its XLA convs (``0``).  The fused gate
    agrees with JAX's at every map of the two walks once the flag is set."""
    for k, v in (("NATDIFF_PALLAS_CONV", flag), ("NATDIFF_CONV_TILED", tiled)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert tconv.tiled_variant() == jconv.tiled_variant()
    assert tconv.default_variant() == jconv.default_variant()
    if flag is None:
        assert tconv.pallas_conv_enabled() and tconv.fused_resblock_enabled()
        assert not jconv.pallas_conv_enabled()
        monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    assert tconv.pallas_conv_enabled() == jconv.pallas_conv_enabled()
    assert tconv.fused_resblock_enabled() == jconv.fused_resblock_enabled()
    for shape, cout in (((64, 32, 32, 128), 128), ((4, 256, 256, 128), 128),
                        ((4, 64, 64, 256), 256), ((2, 8, 8, 96), 128)):
        meta = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        jx = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        assert tconv.fused_resblock_ok(meta, cout) == \
            jconv.fused_resblock_ok(jx, cout), (flag, shape)
