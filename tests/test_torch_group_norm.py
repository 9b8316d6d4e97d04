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
