"""The backward of the training kernels against the JAX package's: K2
(``conv3x3``), K4 (``conv3x3_tiled``) and K3 (``conv3x3_gn``) through the
port's ``_ConvFn`` on the CPU (its forward the plain version, its backward
autograd through the library twin) against ``jax.grad`` through
``conv3x3_pallas`` (its custom VJP; the tiled variants) and
``conv3x3_gn_pallas`` (the fused kernel's VJP, with cotangents on its
channel sums), both in interpret mode; K6 (``fused_group_norm``) through
``_GroupNormFn`` against ``jax.grad`` of ``group_norm_xla_channel`` and of
JAX's ``fused_group_norm`` with ``extra_bias`` (XLA on the CPU).

Limits: f32 1e-5 relative L2 per gradient.  bf16: 1.5x the control, the
JAX bf16 gradient against the JAX f32 one (measured in this file; for K3 the
bf16 gradient of JAX's XLA twin written with a bf16 conv output, since the
fused VJP raises in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops import conv3x3 as jconv
from naturaldiffusion_tpu.ops import group_norm as jgn
from naturaldiffusion_tpu_torch.ops import conv3x3 as C
from naturaldiffusion_tpu_torch.ops import group_norm as G
from torch_port_util import rel_l2

torch.set_num_threads(2)
TOL = 1e-5
BF16_FACTOR = 1.5
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                      torch.bfloat16)}


def _arrays(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _weights(shape):
    """A fixed cotangent pattern (the JAX test's cos weighting)."""
    n = int(np.prod(shape))
    return np.cos(np.arange(n, dtype=np.float32)).reshape(shape)


def _port_grads(fn, arrays, dtype, need):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(bool(n))
          for a, n in zip(arrays, need)]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    assert type(outs[0].grad_fn).__name__ in ("_ConvFnBackward",
                                               "_GroupNormFnBackward")
    loss = sum((o.to(torch.float32) * torch.from_numpy(_weights(o.shape))
                ).sum() * s for o, s in zip(outs, (1.0, 0.3, 0.01)))
    grads = torch.autograd.grad(loss, [t for t, n in zip(ts, need) if n])
    return [g.to(torch.float32).numpy() for g in grads]


def _jax_grads(fn, arrays, dtype, need):
    idx = tuple(i for i, n in enumerate(need) if n)

    def loss(*a):
        out = fn(*[x.astype(dtype) for x in a])
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o.astype(jnp.float32) * _weights(o.shape)).sum() * s
                   for o, s in zip(outs, (1.0, 0.3, 0.01)))
    with jax.enable_x64(False):
        g = jax.grad(loss, idx)(*[jnp.asarray(a) for a in arrays])
    return [np.asarray(x, np.float32) for x in g]


def _compare(port_fn, jax_fn, arrays, need, dt, jax_bf16_fn=None):
    """The port's grads in ``dt`` against JAX's: f32 within ``TOL``; bf16
    within ``BF16_FACTOR`` x the control, the JAX bf16 grads (of
    ``jax_bf16_fn`` where given) against the JAX f32 ones, both from JAX's
    bf16 grads and from its f32 ones."""
    jdt, tdt = DT[dt]
    got = _port_grads(port_fn, arrays, tdt, need)
    want = _jax_grads(jax_bf16_fn or jax_fn, arrays, jdt, need)
    if dt == "f32":
        for g, w in zip(got, want):
            assert np.abs(w).max() > 0
            assert rel_l2(g, w) < TOL
        return
    ref = _jax_grads(jax_fn, arrays, jnp.float32, need)
    for g, w, r in zip(got, want, ref):
        control = rel_l2(w, r)
        assert rel_l2(g, w) < BF16_FACTOR * control + 1e-6, (
            rel_l2(g, w), control)
        assert rel_l2(g, r) < BF16_FACTOR * control + 1e-6


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(128, 128), (128, 256)])
def test_k2_grads(dt, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x, w, b = _arrays(rng, [(2, 4, 4, cin), (3, 3, cin, cout), (cout,)])
    w *= 0.05
    _compare(C.conv3x3, jconv.conv3x3_pallas, [x, w, b], (1, 1, 1), dt)


def test_k2_grads_stem_and_head():
    """The model's 3 -> 128 stem and 128 -> 3 head, which JAX's kernel does
    not take: against ``conv3x3_xla``'s autodiff."""
    for cin, cout in ((3, 128), (128, 3)):
        rng = np.random.default_rng(cin)
        x, w, b = _arrays(rng, [(2, 8, 8, cin), (3, 3, cin, cout), (cout,)])
        _compare(C.conv3x3, jconv.conv3x3_xla, [x, w, b], (1, 1, 1), "f32")


@pytest.mark.parametrize("variant", ["tiled", "tiledew"])
def test_k4_grads(variant):
    rng = np.random.default_rng(7)
    x, w, b = _arrays(rng, [(1, 8, 8, 128), (3, 3, 128, 128), (128,)])
    w *= 0.05
    _compare(C.conv3x3_tiled,
             lambda x, w, b: jconv.conv3x3_pallas(x, w, b, variant=variant),
             [x, w, b], (1, 1, 1), "f32")


K3_CASES = [
    # pre, skip, skip_rescale, emit_stats
    (True, True, True, True),
    (True, False, False, True),
    (False, True, False, False),
    (True, True, False, False),
    (False, False, False, True),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_grads(dt, case):
    """Every input's cotangent (x, w, b, the prologue's w_c and b_c, the
    skip), with cotangents on y, s1 and s2."""
    has_pre, has_skip, rescale, stats = case
    rng = np.random.default_rng(sum(case))
    x, w, b, pw, pb, skip = _arrays(rng, [
        (2, 4, 4, 128), (3, 3, 128, 128), (128,), (2, 128), (2, 128),
        (2, 4, 4, 128)])
    w *= 0.05
    arrays = [x, w, b] + ([pw, pb] if has_pre else []) \
        + ([skip] if has_skip else [])

    def unpack(a):
        it = iter(a[3:])
        pre = (next(it), next(it)) if has_pre else None
        sk = next(it) if has_skip else None
        return a[0], a[1], a[2], pre, sk

    def port_fn(*a):
        x_, w_, b_, pre, sk = unpack(a)
        return C.conv3x3_gn(x_, w_, b_, pre=pre, skip=sk,
                            skip_rescale=rescale, emit_stats=stats)

    def jax_fn(*a):
        x_, w_, b_, pre, sk = unpack(a)
        if pre is not None:     # the prologue's coefficients stay f32
            pre = tuple(p.astype(jnp.float32) for p in pre)
        return jconv.conv3x3_gn_pallas(x_, w_, b_, pre=pre, skip=sk,
                                       skip_rescale=rescale,
                                       emit_stats=stats)

    def jax_bf16_fn(*a):
        """JAX's ``_fused_reference_xla`` with the conv's output in bf16:
        the fused VJP itself raises in bf16 (``conv_general_dilated`` of
        bf16 operands with float32 accumulation has no transpose)."""
        x_, w_, b_, pre, sk = unpack(a)
        xin = x_
        if pre is not None:
            xf = (x_.astype(jnp.float32) * pre[0].astype(jnp.float32)[
                :, None, None, :] + pre[1].astype(jnp.float32)[
                :, None, None, :])
            xin = (xf * jax.nn.sigmoid(xf)).astype(x_.dtype)
        acc = jax.lax.conv_general_dilated(
            xin, w_, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")).astype(jnp.float32)
        acc = acc + b_.astype(jnp.float32)
        if sk is not None:
            acc = acc + sk.astype(jnp.float32)
            if rescale:
                acc = acc * 0.7071067811865476
        y = acc.astype(x_.dtype)
        if not stats:
            return y
        return y, acc.sum(axis=(1, 2)), (acc * acc).sum(axis=(1, 2))

    if has_pre and dt == "bf16":
        # the port's prologue coefficients are float32 on both sides
        def port_fn(*a, _f=port_fn):  # noqa: F811
            a = list(a)
            a[3], a[4] = a[3].to(torch.float32), a[4].to(torch.float32)
            return _f(*a)
    _compare(port_fn, jax_fn, arrays, (1,) * len(arrays), dt,
             jax_bf16_fn=jax_bf16_fn if dt == "bf16" else None)


def test_k3_stats_cotangent_reaches_every_input():
    """A cotangent on s2 alone moves x, w, b, pre and skip (none of them
    stays zero): the statistics feed the next GroupNorm."""
    rng = np.random.default_rng(3)
    x, w, b, pw, pb, skip = (torch.from_numpy(a).requires_grad_() for a in
                             _arrays(rng, [(2, 4, 4, 8), (3, 3, 8, 8), (8,),
                                           (2, 8), (2, 8), (2, 4, 4, 8)]))
    _, _, s2 = C.conv3x3_gn(x, w, b, pre=(pw, pb), skip=skip,
                            skip_rescale=True, emit_stats=True)
    grads = torch.autograd.grad(s2.sum(), (x, w, b, pw, pb, skip))
    assert all(float(g.abs().max()) > 0 for g in grads)


GN_CASES = [  # groups, act, extra bias rows (0: none)
    (32, None, 0), (32, "silu", 0), (8, "silu", 2), (32, "silu", 1),
    (4, None, 2)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", GN_CASES)
def test_k6_grads(dt, case):
    """x, scale, bias (and extra_bias) grads of K6's Function against JAX's
    XLA GroupNorm: ``group_norm_xla_channel`` without an extra bias,
    ``fused_group_norm`` (x + extra bias, then the XLA GroupNorm) with
    one."""
    groups, act, rows = case
    rng = np.random.default_rng(groups + rows)
    x, scale, bias, eb = _arrays(rng, [(2, 4, 4, 128), (128,), (128,),
                                       (max(rows, 1), 128)])
    scale = 1.0 + 0.1 * scale
    arrays = [x, scale, bias] + ([eb] if rows else [])

    def port_fn(x_, s_, b_, *e):
        return G.fused_group_norm(x_, s_.to(torch.float32),
                                  b_.to(torch.float32), groups, act=act,
                                  extra_bias=e[0] if e else None)

    def jax_fn(x_, s_, b_, *e):
        if e:
            return jgn.fused_group_norm(x_, s_, b_, groups, act=act,
                                        extra_bias=e[0])
        return jgn.group_norm_xla_channel(x_, s_, b_, groups, act=act)

    _compare(port_fn, jax_fn, arrays, (1,) * len(arrays), dt)


def _f64(rng, shapes):
    return [torch.from_numpy(rng.standard_normal(s)) for s in shapes]


@pytest.mark.parametrize("case", K3_CASES + [(False,) * 4])
def test_conv_backward_is_the_twins_vjp(case):
    """The Function's written-out backward against autograd through
    ``conv3x3_twin`` in float64: the same derivative to rounding."""
    has_pre, has_skip, rescale, stats = case
    rng = np.random.default_rng(11 + sum(case))
    x, w, b, pw, pb, skip, gy = _f64(rng, [(2, 5, 4, 8), (3, 3, 8, 6), (6,),
                                           (2, 8), (2, 8), (2, 5, 4, 6),
                                           (2, 5, 4, 6)])
    # the channel sums are float32 outputs (the kernel's): cotangents that
    # float32 holds exactly
    gs1, gs2 = (t.float().double() for t in _f64(rng, [(2, 6), (2, 6)]))
    ins = [x, w, b, pw if has_pre else None, pb if has_pre else None,
           skip if has_skip else None]

    def call(fn, ts):
        x_, w_, b_, pw_, pb_, sk_ = ts
        return fn(x_, w_, b_, pre=None if pw_ is None else (pw_, pb_),
                  skip=sk_, skip_rescale=rescale, emit_stats=stats)
    cots = (gy, gs1, gs2) if stats else (gy,)
    got, want = ([None if t is None else t.clone().requires_grad_()
                  for t in ins] for _ in range(2))
    out_g = call(C.conv3x3_gn, got)
    out_w = call(C.conv3x3_twin, want)
    outs_g = out_g if stats else (out_g,)
    outs_w = out_w if stats else (out_w,)
    assert type(outs_g[0].grad_fn).__name__ == "_ConvFnBackward"
    tg = [t for t in got if t is not None]
    tw = [t for t in want if t is not None]
    gg = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs_g, cots)),
                             tg)
    gw = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs_w, cots)),
                             tw)
    for a, b_ in zip(gg, gw):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("case", GN_CASES)
def test_group_norm_backward_is_the_twins_vjp(case):
    groups, act, rows = case
    groups = min(groups, 4)
    rng = np.random.default_rng(groups + rows + 5)
    x, scale, bias, eb, gy = _f64(rng, [(2, 3, 5, 8), (8,), (8,),
                                        (max(rows, 1), 8), (2, 3, 5, 8)])
    ins = [x, 1.0 + 0.1 * scale, bias, eb if rows else None]
    got, want = ([None if t is None else t.clone().requires_grad_()
                  for t in ins] for _ in range(2))
    yg = G.fused_group_norm(got[0], got[1], got[2], groups, act=act,
                            extra_bias=got[3])
    yw = G.group_norm_twin(want[0], want[1], want[2], groups, act=act,
                           extra_bias=want[3])
    assert type(yg.grad_fn).__name__ == "_GroupNormFnBackward"
    gg = torch.autograd.grad((yg * gy).sum(),
                             [t for t in got if t is not None])
    gw = torch.autograd.grad((yw * gy).sum(),
                             [t for t in want if t is not None])
    for a, b_ in zip(gg, gw):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-9,
                                   atol=1e-11)
