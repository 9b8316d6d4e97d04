"""The port's W8A16 path: ``quantize_weight`` and ``qmatmul_ok`` equal to
the JAX package's, and the plain version of kernel K7 against the JAX
Pallas kernel (interpret mode on the CPU) at scaled-down DiT shapes."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.qmatmul import matmul_wdq as jax_matmul_wdq
from naturaldiffusion_tpu.ops.qmatmul import qmatmul_ok as jax_qmatmul_ok
from naturaldiffusion_tpu.ops.quant import quantize_weight as jax_quantize
from naturaldiffusion_tpu_torch.ops import qmatmul as Q
from naturaldiffusion_tpu_torch.ops.quant import quantize_weight

torch.set_num_threads(2)

# DiT-XL/2's (K, N) of qkv, proj, fc1, fc2 divided by 4.5: hidden 256
SHAPES = [(256, 768), (256, 256), (256, 1024), (1024, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((256, 768), -1), ((1152, 128), -1),
                                        ((3, 3, 16, 32), -1), ((64, 48), 0)])
def test_quantize_weight_equals_jax(shape, axis, dtype):
    """int8 values exactly equal, scales equal to f32 rounding (they are
    one f32 division of the same max on both sides)."""
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    want_i8, want_s = jax_quantize(jw, axis=axis)
    got_i8, got_s = quantize_weight(
        torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
            getattr(torch, dtype)), axis=axis)
    assert got_i8.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(want_i8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_weight_rounds_half_to_even():
    """Scale exactly 1 (max 127): the .5 cases round to even as
    ``jnp.round`` does, and the extremes clip at +-127."""
    w = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -127.0]],
                 np.float32).T.repeat(2, axis=1)
    want_i8, _ = jax_quantize(jnp.asarray(w), axis=-1)
    got_i8, got_s = quantize_weight(torch.from_numpy(w), axis=-1)
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(want_i8))
    assert got_s.flatten().tolist() == [1.0, 1.0]
    assert got_i8[:, 0].tolist() == [127, 2, -4, 0, 0, 2, -127]


def test_qmatmul_ok_equals_jax():
    ms = [1, 7, 16, 24, 32, 48, 64, 100, 512, 1024, 4096]
    ks = [64, 128, 200, 256, 1152, 4608, 8192, 8320]
    ns = [96, 128, 384, 640, 1152, 3456, 4608]
    for m, k, n in itertools.product(ms, ks, ns):
        assert Q.qmatmul_ok(m, k, n) == jax_qmatmul_ok(m, k, n), (m, k, n)
    # DiT-XL/2 at the CFG pair (M = 512): all four products take the kernel
    for k, n in ((1152, 3456), (1152, 1152), (1152, 4608), (4608, 1152)):
        assert Q.qmatmul_ok(512, k, n)


def _operands(k, n, x_dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    w_i8, s_w = jax_quantize(jnp.asarray(w), axis=-1)
    jb = jnp.asarray(b).astype(x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    tw = torch.from_numpy(np.array(w_i8))
    ts = torch.from_numpy(np.array(s_w).reshape(-1))
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tx.dtype)
    return (jx, w_i8, s_w.reshape(-1), jb), (tx, tw, ts, tb)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("k,n", SHAPES)
def test_reference_matches_jax_kernel(k, n, with_bias, x_dtype):
    """The same int8 weights and inputs through the JAX Pallas kernel
    (interpret mode) and the port's plain version: exact products, f32
    sums in another order (~1e-6 relative), so a float32 output agrees to
    1e-5, and a bfloat16 output rounds to the same value or, when the two
    f32 sums straddle a rounding boundary, to its neighbour: one bf16 step,
    at most 2^-7 of |y|."""
    (jx, jw, js, jb), (tx, tw, ts, tb) = _operands(k, n, x_dtype, seed=k + n)
    want = np.asarray(jax_matmul_wdq(jx, jw, js, jb if with_bias else None)
                      .astype(jnp.float32))
    got = Q.matmul_wdq(tx, tw, ts, tb if with_bias else None)
    assert got.dtype == tx.dtype and got.shape == (2, 32, n)
    got = got.float().numpy()
    assert np.abs(want).max() > 0.5
    if x_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_matmul_wdq_raises_outside_the_gate():
    x = torch.zeros((7, 128))                 # M = 7: no row block
    w = torch.zeros((128, 128), dtype=torch.int8)
    s = torch.ones(128)
    before = Q.matmul_wdq.launches
    with pytest.raises(ValueError, match="shape gate"):
        Q.matmul_wdq(x, w, s)
    with pytest.raises(ValueError, match="int8"):
        Q.matmul_wdq(torch.zeros((16, 128)), w.float(), s)
    Q.matmul_wdq(torch.zeros((16, 128)), w, s)
    assert Q.matmul_wdq.launches == before    # the CPU launches no kernel
