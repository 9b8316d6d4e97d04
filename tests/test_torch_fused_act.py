"""The port's fused bias-add + leaky ReLU (kernel K8's plain version)
against the JAX package's ``fused_leaky_relu`` and its Pallas kernel in
interpret mode, bit for bit in float32 and bfloat16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops import fused_act as J
from naturaldiffusion_tpu_torch.ops import fused_act as P
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

# [2, 4, 4, 128]: 32 rows; [3, 300, 128]: 900 rows, not a multiple of the
# TPU kernel's 512-row tile (JAX pads the last tile); [5, 7, 3]: rows of 3
# channels, shorter than one 16-byte vector of the CUDA kernel
SHAPES = [(2, 4, 4, 128), (3, 300, 128), (5, 7, 3)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, b


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_leaky_relu_matches_jax_bit_for_bit(shape, dtype):
    """Each operation rounds to x's type in both packages: in bf16 a slope
    or scale left unrounded changes ~10 % of the outputs by one step."""
    x, b = _inputs(shape)
    jx, jb = jnp.asarray(x, dtype), jnp.asarray(b, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    want = _np(J.fused_leaky_relu(jx, jb))
    want_pallas = _np(J.fused_leaky_relu_pallas(jx, jb, interpret=True))
    np.testing.assert_array_equal(want, want_pallas)
    got = P.fused_leaky_relu(tx, tb)
    assert got.dtype == tx.dtype and got.shape == shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    for interpret in (False, True):
        got_p = P.fused_leaky_relu_pallas(tx, tb, interpret=interpret)
        np.testing.assert_array_equal(got_p.float().numpy(), want_pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_without_bias_and_with_other_constants(dtype):
    x, b = _inputs((4, 6, 128), seed=1)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(P.fused_leaky_relu(tx).float().numpy(),
                                  _np(J.fused_leaky_relu(jx)))
    kw = dict(negative_slope=0.1, scale=0.7)
    np.testing.assert_array_equal(
        P.fused_leaky_relu_pallas(tx, torch.from_numpy(b), **kw)
        .float().numpy(),
        _np(J.fused_leaky_relu_pallas(jx, jnp.asarray(b), interpret=True,
                                      **kw)))


def test_bias_in_float32_is_cast_to_x_type():
    """A float32 bias meets bf16 x in x's type, as JAX casts it."""
    x, b = _inputs((2, 8, 128), seed=2)
    jx = jnp.asarray(x, jnp.bfloat16)
    got = P.fused_leaky_relu_pallas(torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        _np(J.fused_leaky_relu_pallas(jx, jnp.asarray(b), interpret=True)))


def test_cpu_calls_launch_nothing_and_bad_bias_raises():
    x = torch.randn(4, 16)
    before = P.fused_leaky_relu_pallas.launches
    P.fused_leaky_relu_pallas(x, torch.zeros(16))
    assert P.fused_leaky_relu_pallas.launches == before
    with pytest.raises(ValueError, match="bias"):
        P.fused_leaky_relu_pallas(x, torch.zeros(8))
    assert P.SQRT2 == J.SQRT2
