"""The port's attention: the plain version of kernel K9 against the JAX
package's ``mha``, both its einsum pair and its Pallas flash kernel (in
interpret mode, as ``tests/test_attention.py`` runs it), and the CPU
dispatch of ``mha``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from naturaldiffusion_tpu.ops.attention import mha as jax_mha
from naturaldiffusion_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# float32 on both sides, the same softmax, sums in other orders (~1e-6);
# the tolerance of tests/test_attention.py
TOL = 2e-5


def _qkv(t, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, t, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("d", [64, 72, 16, 32])
@pytest.mark.parametrize("t", [256, 200])
def test_reference_matches_jax(t, d, backend):
    """t = 200 is unaligned: JAX pads it to 256 and masks the pad keys by
    segment ids; the port's kernel masks keys past t itself, and its plain
    version never sees them."""
    q, k, v = _qkv(t, d)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    if backend == "flash":
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_mha(*args, backend="flash"))
    else:
        want = np.asarray(jax_mha(*args, backend="xla"))
    got = A.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                          1.0 / math.sqrt(d)).numpy()
    assert got.shape == want.shape == (2, 2, t, d)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mha_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 72, seed=1))
    before = A.flash_attention.launches
    for backend in ("auto", "flash", "xla"):
        got = A.mha(q, k, v, backend=backend)
        torch.testing.assert_close(
            got, A.mha_reference(q, k, v, 1.0 / math.sqrt(72)),
            rtol=0, atol=0)
    got = A.mha(q, k, v, sm_scale=0.3)
    torch.testing.assert_close(got, A.mha_reference(q, k, v, 0.3),
                               rtol=0, atol=0)
    # the counter counts kernel launches only
    assert A.flash_attention.launches == before


def test_strided_qkv_views_as_the_dit_passes_them():
    """The DiT hands over views of one [B, T, 3, H, D] tensor; the result
    equals that of contiguous copies, and bf16 stays bf16."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 40, 3, 4, 72)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    want = A.mha(*(a.contiguous() for a in (q, k, v)))
    torch.testing.assert_close(A.mha(q, k, v), want, rtol=0, atol=0)
    got16 = A.mha(*(a.bfloat16() for a in (q, k, v)))
    assert got16.dtype == torch.bfloat16 and got16.shape == (2, 4, 40, 72)


@pytest.mark.parametrize("backend", ["ring"])
def test_unported_backends_raise(backend):
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 64))
    with pytest.raises(NotImplementedError, match="slice"):
        A.mha(q, k, v, backend=backend)


def test_bad_backend_and_shapes_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 64))
    with pytest.raises(ValueError, match="backend"):
        A.mha(q, k, v, backend="nope")
    with pytest.raises(ValueError, match="shape"):
        A.flash_attention(q, k[:, :, :8], v, 0.1)


# bf16 q, k, v: the two "xla" backends both round the scores and the
# probabilities to bf16, in other places (JAX rounds exp(s - max) before the
# sum, the port's softmax rounds its f32 result once).  The measured control
# is the distance of JAX's bf16 "xla" from the f32 attention on the same
# inputs (5.2e-3 at d = 16, 6.3e-3 at d = 72, relative L2); two bf16 runs
# with independent roundings lie up to sqrt(2) x the control apart
# (measured: 0.77x and 0.98x).  Bound at 1.5x the control; a wrong scale
# or a softmax over the wrong axis moves the output by O(1)
XLA_BF16_CONTROL_FACTOR = 1.5


@pytest.mark.parametrize("d", [16, 72])
def test_xla_backend_matches_jax_in_bf16(d):
    q, k, v = _qkv(64, d, seed=3)
    jb = tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want16 = np.asarray(jax_mha(*jb, backend="xla"), np.float32)
    want32 = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                                backend="xla"))
    got16 = A.mha(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                  backend="xla")
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().numpy()
    control = float(np.linalg.norm(want16 - want32) / np.linalg.norm(want32))
    assert 1e-3 < control < 5e-2
    err = float(np.linalg.norm(got16 - want16) / np.linalg.norm(want16))
    assert err <= XLA_BF16_CONTROL_FACTOR * control
