"""The port's splash attention (kernel K10's plain version) and
``mha_joint`` against the JAX package: its ``mha(backend=
"splash_interpret")`` (the Pallas splash kernel in interpret mode), the
residuals of a splash kernel built here with ``save_residuals=True``, and
its ``mha_joint(interpret=True)``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_kernel as sk, splash_attention_mask as sm_lib)

from naturaldiffusion_tpu.ops.attention import mha as jax_mha
from naturaldiffusion_tpu.ops.attention import mha_joint as jax_mha_joint
from naturaldiffusion_tpu_torch.ops import attention as A
from torch_port_util import rel_l2

torch.set_num_threads(2)

# the tolerance of tests/test_attention.py for JAX's splash against its
# einsum pair (measured here: 5e-7 at t = 256 and 300, f32)
SPLASH_TOL = 3e-3
# float32 softmax on both sides, sums in other orders (~5e-7 measured)
TIGHT_TOL = 2e-5
# logsumexp of f32 scores over <= 300 keys: 5e-7 measured against float64
LSE_TOL = 1e-5
# bf16 q, k, v: JAX's bf16 splash lies 3.4e-3 (relative L2) from its f32
# run on the same inputs (the measured control); the port's bf16 output
# lies 2e-5 to 5e-5 from JAX's bf16 one.  Bound at 1.5 x the control, the
# convention of the other bf16 tests of the port
BF16_CONTROL_FACTOR = 1.5


def _qkv(t, d=64, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, t, d)).astype(np.float32)
                 for _ in range(3))


def _jax(arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


def _torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("backend", ["splash", "splash_interpret"])
@pytest.mark.parametrize("t", [256, 300])
def test_splash_matches_jax(t, backend):
    """t = 300 is unaligned: JAX pads it to 384 and masks the pad keys by
    segment ids; the port's plain version never sees them."""
    qkv = _qkv(t)
    want = np.asarray(jax_mha(*_jax(qkv), backend="splash_interpret"))
    want_xla = np.asarray(jax_mha(*_jax(qkv), backend="xla"))
    got = A.mha(*_torch(qkv), backend=backend).numpy()
    assert got.shape == want.shape == (2, 2, t, 64)
    np.testing.assert_allclose(got, want, atol=SPLASH_TOL, rtol=SPLASH_TOL)
    np.testing.assert_allclose(got, want_xla, atol=TIGHT_TOL, rtol=TIGHT_TOL)


@pytest.mark.parametrize("t", [256, 300])
def test_splash_matches_jax_in_bf16(t):
    qkv = _qkv(t, seed=1)
    want16 = np.asarray(jax_mha(*_jax(qkv, jnp.bfloat16),
                                backend="splash_interpret"), np.float32)
    want32 = np.asarray(jax_mha(*_jax(qkv), backend="splash_interpret"))
    got16 = A.mha(*_torch(qkv, torch.bfloat16), backend="splash")
    assert got16.dtype == torch.bfloat16
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 2e-2
    assert rel_l2(got16.float().numpy(), want16) <= (
        BF16_CONTROL_FACTOR * control)


@pytest.mark.parametrize("scale", [0.125, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prescale_rounds_as_jax(dtype, scale):
    """JAX multiplies q by a weakly typed scale, rounded to q's type first;
    at 0.3 in bf16 a product with the unrounded scale differs in thousands
    of elements."""
    (q,) = _qkv(64, seed=2)[:1]
    jq = np.asarray((jnp.asarray(q, dtype) * scale).astype(dtype),
                    np.float32)
    got = A.prescale(torch.from_numpy(q).to(getattr(torch, dtype)), scale)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), jq)


@pytest.mark.parametrize("t", [256, 384])
def test_lse_matches_the_jax_kernel_residuals(t):
    """The logsumexp that ``save_residuals=True`` returns is in natural-log
    units of the pre-scaled scores, per head and row."""
    h, d = 2, 64
    q, k, v = (a[0] for a in _qkv(t, d=d, b=1, h=h, seed=3))
    sm_scale = 1.0 / math.sqrt(d)
    blk = 128
    sizes = sk.BlockSizes(
        block_q=blk, block_kv=blk, block_kv_compute=blk, block_q_dkv=blk,
        block_kv_dkv=blk, block_kv_dkv_compute=blk, block_q_dq=blk,
        block_kv_dq=blk)
    kernel = sk.make_splash_mha_single_device(
        mask=sm_lib.MultiHeadMask([sm_lib.FullMask((t, t))] * h),
        block_sizes=sizes, save_residuals=True, interpret=True)
    qs = (jnp.asarray(q) * sm_scale).astype(jnp.float32)
    want_o, (want_lse,) = kernel(qs, jnp.asarray(k), jnp.asarray(v))
    got_o, got_lse = A.splash_attention(
        *(torch.from_numpy(a)[None] for a in (q, k, v)), sm_scale,
        save_residuals=True)
    assert got_lse.shape == (1, h, t) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse[0].numpy(), np.asarray(want_lse),
                               atol=LSE_TOL, rtol=LSE_TOL)
    np.testing.assert_allclose(got_o[0].numpy(), np.asarray(want_o),
                               atol=TIGHT_TOL, rtol=TIGHT_TOL)


def _joint_qkv():
    b, h, d, split, tc = 1, 2, 64, 512, 37
    return _qkv(split + tc, d=d, b=b, h=h, seed=4), split


def test_mha_joint_matches_jax():
    """The split softmax against JAX's, both on the fast path
    (``interpret=True``), and against one full softmax per row; JAX's
    own test holds its op to 2e-5."""
    qkv, split = _joint_qkv()
    want = np.asarray(jax_mha_joint(*_jax(qkv), split=split,
                                    interpret=True))
    full = np.asarray(jax_mha(*_jax(qkv), backend="xla"))
    got = A.mha_joint(*_torch(qkv), split=split, interpret=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TIGHT_TOL, rtol=TIGHT_TOL)
    np.testing.assert_allclose(got, full, atol=TIGHT_TOL, rtol=TIGHT_TOL)


def test_mha_joint_matches_jax_in_bf16():
    """bf16: JAX's bf16 split softmax lies 3.8e-3 from its f32 run (the
    control); the port's lies 5e-5 from JAX's bf16 one."""
    qkv, split = _joint_qkv()
    want16 = np.asarray(jax_mha_joint(*_jax(qkv, jnp.bfloat16), split=split,
                                      interpret=True), np.float32)
    want32 = np.asarray(jax_mha_joint(*_jax(qkv), split=split,
                                      interpret=True))
    got16 = A.mha_joint(*_torch(qkv, torch.bfloat16), split=split,
                        interpret=True)
    assert got16.dtype == torch.bfloat16
    control = rel_l2(want16, want32)
    assert 1e-3 < control < 2e-2
    assert rel_l2(got16.float().numpy(), want16) <= (
        BF16_CONTROL_FACTOR * control)


def test_mha_joint_falls_back_to_mha():
    """An unaligned split, the ``"xla"`` backend, or a CPU tensor without
    ``interpret`` take :func:`mha`, as JAX's ``mha_joint`` does off the
    TPU; the split path's latent block launches nothing on the CPU."""
    qkv, split = _joint_qkv()
    q, k, v = _torch(qkv)
    before = A.splash_attention.launches
    torch.testing.assert_close(A.mha_joint(q, k, v, split=500,
                                           interpret=True),
                               A.mha(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(A.mha_joint(q, k, v, split=split,
                                           backend="xla", interpret=True),
                               A.mha(q, k, v, backend="xla"), rtol=0, atol=0)
    torch.testing.assert_close(A.mha_joint(q, k, v, split=split),
                               A.mha(q, k, v), rtol=0, atol=0)
    A.mha_joint(q, k, v, split=split, interpret=True)
    assert A.splash_attention.launches == before
    want = np.asarray(jax_mha_joint(*_jax(qkv), split=500))
    np.testing.assert_allclose(
        A.mha_joint(q, k, v, split=500, interpret=True).numpy(), want,
        atol=TIGHT_TOL, rtol=TIGHT_TOL)


def test_splash_attention_checks_its_inputs():
    q, k, v = _torch(_qkv(16))
    with pytest.raises(ValueError, match="shape"):
        A.splash_attention(q, k[:, :, :8], v, 0.1)
    out = A.splash_attention(q, k, v, 0.1)
    torch.testing.assert_close(
        out, A.splash_reference(A.prescale(q, 0.1), k, v), rtol=0, atol=0)
