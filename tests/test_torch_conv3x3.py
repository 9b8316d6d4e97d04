"""Port's conv3x3 / conv3x3_gn (plain versions of kernels K2 / K3) against
the JAX package's XLA conv and its fused Pallas kernel in interpret mode."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.conv3x3 import conv3x3_gn_pallas, conv3x3_xla
from naturaldiffusion_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_gn

torch.set_num_threads(2)

# f32: sums of 9*Cin O(1) products in another order, ~1e-6
RTOL, ATOL = 1e-5, 1e-5
# bf16 outputs: one bf16 rounding (2^-8) of O(1) values, either side
BF16_TOL = 2e-2


def _inputs(rng, b, h, w, cin, cout):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout))
          / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    pw = (1.0 + 0.2 * rng.standard_normal((b, cin))).astype(np.float32)
    pb = (0.3 * rng.standard_normal((b, cin))).astype(np.float32)
    skip = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, (pw, pb), skip


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("cin,cout", [(3, 128), (128, 128), (128, 3),
                                      (128, 256)])
def test_conv3x3_matches_xla(cin, cout):
    """Includes the 3->nf stem and the nf->3 head, which the port sends
    through the same kernel."""
    rng = np.random.default_rng(cin + cout)
    x, wt, bias, _, _ = _inputs(rng, 2, 8, 8, cin, cout)
    want = np.asarray(conv3x3_xla(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(bias)))
    before = conv3x3.launches
    got = conv3x3(_t(x), _t(wt), _t(bias)).numpy()
    assert conv3x3.launches == before
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("pre,skip,stats",
                         list(itertools.product([False, True], repeat=3)))
def test_conv3x3_gn_matches_pallas(pre, skip, stats, cout):
    rng = np.random.default_rng(8 * cout + 4 * pre + 2 * skip + stats)
    x, wt, bias, pw_pb, sk = _inputs(rng, 2, 8, 8, 128, cout)
    kw = dict(skip_rescale=skip, emit_stats=stats)
    want = conv3x3_gn_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        pre=tuple(map(jnp.asarray, pw_pb)) if pre else None,
        skip=jnp.asarray(sk) if skip else None, interpret=True, **kw)
    got = conv3x3_gn(_t(x), _t(wt), _t(bias),
                     pre=tuple(map(_t, pw_pb)) if pre else None,
                     skip=_t(sk) if skip else None, **kw)
    if not stats:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        # sums over 64 pixels of O(1) values
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=64 * ATOL)


def test_conv3x3_gn_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    x, wt, bias, pw_pb, sk = _inputs(rng, 2, 8, 8, 128, 128)
    bf = jnp.bfloat16
    want, w1, w2 = conv3x3_gn_pallas(
        jnp.asarray(x, bf), jnp.asarray(wt, bf), jnp.asarray(bias, bf),
        pre=tuple(map(jnp.asarray, pw_pb)), skip=jnp.asarray(sk, bf),
        skip_rescale=True, emit_stats=True, interpret=True)
    b16 = torch.bfloat16
    got, g1, g2 = conv3x3_gn(_t(x, b16), _t(wt, b16), _t(bias, b16),
                             pre=tuple(map(_t, pw_pb)), skip=_t(sk, b16),
                             skip_rescale=True, emit_stats=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=BF16_TOL,
                               atol=64 * BF16_TOL)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=BF16_TOL,
                               atol=64 * BF16_TOL)


def test_conv3x3_gn_pads_after_the_prologue():
    """SAME padding pads the post-SiLU activation with zeros: with a large
    ``pre_b`` the border outputs differ from padding ``silu(pre_b)``."""
    rng = np.random.default_rng(3)
    x, wt, bias, (pw, pb), _ = _inputs(rng, 1, 4, 4, 128, 128)
    pb = np.full_like(pb, 3.0)
    got = conv3x3_gn(_t(x), _t(wt), _t(bias), pre=(_t(pw), _t(pb)))
    act = torch.nn.functional.silu(_t(x) * _t(pw)[:, None, None]
                                   + _t(pb)[:, None, None])
    torch.testing.assert_close(got, conv3x3(act, _t(wt), _t(bias)),
                               rtol=RTOL, atol=ATOL)


def test_conv3x3_rejects_bad_arguments():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3x3(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError):
        conv3x3_gn(x, torch.zeros(3, 3, 8, 8), skip=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError):
        conv3x3_gn(x, torch.zeros(3, 3, 8, 8),
                   pre=(torch.zeros(2, 8), torch.zeros(2, 8)))


@pytest.mark.parametrize("variant", ["tiled", "tiledew"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 128, 128),
    (1, 12, 4, 128, 256),     # tall/narrow, channel-raising
    (3, 6, 5, 128, 128),      # odd W, batch 3
])
def test_conv3x3_tiled_matches_pallas(shape, variant):
    """The plain version of K4 (which serves both TPU variants) against
    JAX's halo-tiled kernels in interpret mode, at the shapes of
    tests/test_conv3x3.py's tiled test."""
    from naturaldiffusion_tpu.ops.conv3x3 import conv3x3_pallas
    from naturaldiffusion_tpu_torch.ops.conv3x3 import conv3x3_tiled
    b, h, w, ci, co = shape
    rng = np.random.default_rng(h * w + co)
    x, wt, bias, _, _ = _inputs(rng, b, h, w, ci, co)
    want = conv3x3_pallas(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                          variant=variant, interpret=True)
    before = conv3x3_tiled.launches
    got = conv3x3_tiled(_t(x), _t(wt), _t(bias))
    assert conv3x3_tiled.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_route_predicates_match_jax(monkeypatch):
    """``pallas_conv_fits`` and ``fused_resblock_ok`` (with
    NATDIFF_PALLAS_CONV=2 on the JAX side) give the JAX package's answers
    over the maps and channel counts of the NCSN++ configs."""
    from naturaldiffusion_tpu.ops import conv3x3 as jc
    from naturaldiffusion_tpu_torch.ops import conv3x3 as tc
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    for hw in (4, 8, 16, 32, 64, 128, 256, 512):
        for cin, cout in ((128, 128), (256, 128), (128, 256), (384, 256),
                          (512, 256), (256, 256), (3, 128), (640, 512)):
            for item, jdt, tdt in ((2, jnp.bfloat16, torch.bfloat16),
                                   (4, jnp.float32, torch.float32)):
                shape = (2, hw, hw, cin)
                for v in ("valid9", "taps9", "tiled", "tiledew"):
                    assert tc.pallas_conv_fits(shape, cout, item, v) == \
                        jc.pallas_conv_fits(shape, cout, item, v)
                jx = jnp.zeros((1, 1, 1, 1), jdt)
                tx = torch.zeros(1, 1, 1, 1, dtype=tdt)
                for up in (None, 2 * hw):
                    rs = None if up is None else (2, up, up, cin)
                    assert tc.fused_resblock_ok(
                        tx, cout, shape=rs or shape) == \
                        jc.fused_resblock_ok(jx, cout, shape=rs or shape)
