"""Port's GroupNorm maths against the JAX package's (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops import group_norm as jgn
from naturaldiffusion_tpu_torch.ops import group_norm as tgn

torch.set_num_threads(2)

# f32 statistics over 8*8*4 values per group in another order
TOL = 1e-5


def _inputs(seed, c=128):
    rng = np.random.default_rng(seed)
    x = (2.0 + rng.standard_normal((2, 8, 8, c))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tb = (0.5 * rng.standard_normal((2, c))).astype(np.float32)
    return x, scale, bias, tb


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("with_tb", [False, True])
def test_group_norm_reference_matches_jax(act, with_tb):
    x, scale, bias, tb = _inputs(0)
    tb = tb if with_tb else None
    want = jgn.group_norm_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, act=act,
        extra_bias=None if tb is None else jnp.asarray(tb))
    got = tgn.group_norm_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        32, act=act, extra_bias=None if tb is None else torch.from_numpy(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("with_tb", [False, True])
def test_affine_coeffs_match_jax_and_normalize(with_tb):
    """The collapsed coefficients equal the JAX ones, and x * w_c + b_c is
    GroupNorm(x + tb) itself."""
    x, scale, bias, tb = _inputs(1)
    tb = tb if with_tb else None
    js1, js2 = jgn.gn_channel_sums(jnp.asarray(x))
    jw, jb = jgn.gn_affine_coeffs(
        js1, js2, 64, jnp.asarray(scale), jnp.asarray(bias), 32,
        extra_bias=None if tb is None else jnp.asarray(tb))
    tx = torch.from_numpy(x)
    s1, s2 = tgn.gn_channel_sums(tx)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=TOL)
    w, b = tgn.gn_affine_coeffs(
        s1, s2, 64, torch.from_numpy(scale), torch.from_numpy(bias), 32,
        extra_bias=None if tb is None else torch.from_numpy(tb))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
    want = tgn.group_norm_reference(
        tx, torch.from_numpy(scale), torch.from_numpy(bias), 32,
        extra_bias=None if tb is None else torch.from_numpy(tb))
    # the fast-variance formula on x (not x + tb) cancels a little more
    torch.testing.assert_close(tx * w[:, None, None] + b[:, None, None],
                               want, rtol=1e-4, atol=1e-4)


# K6's plain version against the JAX package's Pallas kernel (interpret
# mode), as tests/test_group_norm.py runs it.  f32: the extra bias enters
# the statistics algebraically here and directly there (~1e-6 apart);
# bf16 outputs: one bf16 rounding (2^-8 relative) of nearly equal f32
# values may land on either side, on values up to ~4
K6_TOL = {np.float32: 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("c", [128, 16])
@pytest.mark.parametrize("eb", [None, "BC", "1C"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_k6_plain_matches_pallas(dtype, act, eb, c):
    """C = 16 splits into min(16 // 4, 32) = 4 groups of 4 channels."""
    x, scale, bias, tb = _inputs(7, c)
    if eb == "1C":
        tb = tb[:1]
    groups = min(c // 4, 32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = jnp.asarray(x, jdt)
    jtb = None if eb is None else jnp.broadcast_to(
        jnp.asarray(tb, jdt), (x.shape[0], c))   # as JAX's dispatcher does
    want = jgn.group_norm_pallas(jx, jnp.asarray(scale), jnp.asarray(bias),
                                 groups, act=act, extra_bias=jtb,
                                 interpret=True)
    before = tgn.fused_group_norm.launches
    got = tgn.fused_group_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
        torch.from_numpy(bias), groups, act=act,
        extra_bias=None if eb is None else torch.from_numpy(tb).to(tdt))
    assert tgn.fused_group_norm.launches == before   # CPU: no launch
    assert got.dtype == tdt
    tol = K6_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_fused_group_norm_rejects_bad_arguments():
    x = torch.zeros(2, 4, 4, 16)
    s = torch.ones(16)
    for kw in (dict(num_groups=5), dict(act="gelu"),
               dict(extra_bias=torch.zeros(3, 16)),
               dict(extra_bias=torch.zeros(2, 8))):
        kw = dict(dict(num_groups=4), **kw)
        with pytest.raises(ValueError):
            tgn.fused_group_norm(x, s, s, **kw)
    with pytest.raises(ValueError):
        tgn.fused_group_norm(x, torch.ones(8), s, 4)
