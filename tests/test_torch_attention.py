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
import torch_port_util  # noqa: F401  binds torch's CPU math first

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


# --- the tile loop's block plan (csrc/attention.cu) --------------------------

# (b, h, t, d): DiT-XL/2's call, SD3's three joint lengths, and lengths of
# one key, one short of a tile, one past it, and unaligned
PLAN_SHAPES = [(2, 16, 256, 72), (2, 24, 4096, 64), (2, 24, 4250, 64),
               (2, 24, 4429, 64), (2, 3, 1, 16), (2, 3, 63, 32),
               (2, 3, 65, 64), (2, 3, 250, 72)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,t,d", PLAN_SHAPES)
def test_attn_plan_covers_each_query_once(b, h, t, d, dtype):
    """Each query row of each head is written by exactly one block; the
    key tiles cover [0, t) in order and only the last one, when t is not a
    multiple of 64, is masked; the bf16 ring fits two blocks on an SM."""
    p = A._attn_plan(b, h, t, d, dtype)
    assert p == A._attn_plan(b, h, t, d, dtype)          # pure
    gx, gy = p["grid"]
    assert gy == b * h and p["bq"] == 16 * p["warps"]
    writes = np.zeros(gx * p["bq"], np.int64)
    for bx in range(gx):
        writes[bx * p["bq"]:(bx + 1) * p["bq"]] += 1
    assert (writes[:t] == 1).all() and gx * p["bq"] - t < p["bq"]
    keys = np.zeros(p["key_tiles"] * A._BKV, np.int64)
    for j in range(p["key_tiles"]):
        keys[j * A._BKV:(j + 1) * A._BKV] += 1
    assert (keys[:t] == 1).all() and len(keys) - t < A._BKV
    assert p["masked_tiles"] == ([p["key_tiles"] - 1] if t % A._BKV else [])
    if dtype == torch.float32:
        assert (p["warps"], p["stages"], p["smem"]) == (4, 0, 0)
    else:
        assert p["warps"] in (4, 8) and p["stages"] == A._RING_STAGES
        assert 2 * p["smem"] <= 233_472


def test_attn_plan_at_the_path_shapes():
    """8-warp blocks at SD3's lengths (over 1600 blocks); DiT-XL/2's 4 x 32
    grid keeps 4-warp blocks, one per SM."""
    bf = torch.bfloat16
    assert A._attn_plan(2, 16, 256, 72, bf)["warps"] == 4
    assert A._attn_plan(2, 16, 256, 72, bf)["grid"] == (4, 32)
    for t in (4096, 4250, 4429):
        p = A._attn_plan(2, 24, t, 64, bf)
        assert p["warps"] == 8 and math.prod(p["grid"]) >= 1536


def _walk_plan(q, k, v, sm_scale):
    """The tile loop as its plan runs it, in float32 torch: per block of
    queries, the key tiles in order with the online softmax (running max
    and sum, rescaled accumulator), the index mask only on the plan's
    masked tiles, keys past t read as zeros."""
    b, h, t, d = q.shape
    p = A._attn_plan(b, h, t, d, torch.bfloat16)
    n = p["key_tiles"] * A._BKV
    kp = torch.zeros((b, h, n, d))
    vp = torch.zeros((b, h, n, d))
    kp[:, :, :t], vp[:, :, :t] = k, v
    out = torch.full((b, h, t, d), float("nan"))
    for y in range(p["grid"][1]):
        bi, hi = divmod(y, h)
        for bx in range(p["grid"][0]):
            rows = slice(bx * p["bq"], min(t, (bx + 1) * p["bq"]))
            qq = q[bi, hi, rows]
            m = torch.full((qq.shape[0], 1), -math.inf)
            l = torch.zeros((qq.shape[0], 1))
            acc = torch.zeros((qq.shape[0], d))
            for j in range(p["key_tiles"]):
                keys = slice(j * A._BKV, (j + 1) * A._BKV)
                s = qq @ kp[bi, hi, keys].T * sm_scale
                if j in p["masked_tiles"]:
                    s[:, torch.arange(j * A._BKV, (j + 1) * A._BKV) >= t] = \
                        -math.inf
                m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                alpha = torch.exp(m - m_new)
                e = torch.exp(s - m_new)
                l = l * alpha + e.sum(dim=1, keepdim=True)
                acc = acc * alpha + e @ vp[bi, hi, keys]
                m = m_new
            out[bi, hi, rows] = acc / l
    return out


@pytest.mark.parametrize("t,d", [(1, 16), (63, 32), (65, 64), (250, 72),
                                 (256, 72)])
def test_attn_plan_walk_matches_reference_and_jax(t, d):
    """The plan's tile walk (float32) against the plain version of K9 and
    JAX's ``mha`` (float32 einsum pair) at the tolerance of
    test_reference_matches_jax."""
    q, k, v = _qkv(t, d, seed=t + d)
    sc = 1.0 / math.sqrt(d)
    got = _walk_plan(*(torch.from_numpy(a) for a in (q, k, v)), sc)
    ref = A.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), sc)
    want = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                              backend="xla"))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
