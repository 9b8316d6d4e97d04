"""The port's W8A16 path: ``quantize_weight`` and ``qmatmul_ok`` equal to
the JAX package's, and the plain version of kernel K7 against the JAX
Pallas kernel (interpret mode on the CPU) at scaled-down DiT shapes."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.qmatmul import matmul_wdq as jax_matmul_wdq
from naturaldiffusion_tpu.ops.qmatmul import qmatmul_ok as jax_qmatmul_ok
from naturaldiffusion_tpu.ops.quant import quantize_weight as jax_quantize
from naturaldiffusion_tpu_torch.ops import qmatmul as Q
from naturaldiffusion_tpu_torch.ops.quant import quantize_weight
import torch_port_util  # noqa: F401  binds torch's CPU math first

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


# --- kernel K7's plan and weight layout (csrc/qmatmul.cu) -------------------

# DiT-XL/2's four products at the CFG pair (M = 512), ragged M, the
# narrowest N and the deepest K the gate admits
PLAN_SHAPES = [(512, 1152, 3456), (512, 1152, 1152), (512, 1152, 4608),
               (512, 4608, 1152), (16, 1152, 1152), (272, 1152, 1152),
               (16, 8192, 128), (512, 8192, 128), (4096, 1152, 4608)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_qm_plan_covers_each_output_once(m, k, n):
    """Every output element is written by exactly one block of each split,
    the splits cut the k tiles into contiguous ranges in ascending order
    (the fixed order in which the second kernel sums them), a split grid
    stays within one wave of the card's SMs and takes as many splits as
    that allows, and the shared memory fits a block."""
    p = Q._qm_plan(m, k, n)
    assert p == Q._qm_plan(m, k, n)                 # pure
    assert (p["bn"], p["bk"], p["stages"]) == (Q._BN, Q._BK, Q._STAGES)
    assert p["bm"] == Q._BM
    gx, gy, gz = p["grid"]
    assert gz == p["splits"] == len(p["k_tiles"])
    writes = np.zeros((gz, gy * p["bm"], gx * p["bn"]), np.int64)
    for s in range(gz):
        for by in range(gy):
            for bx in range(gx):
                writes[s, by * p["bm"]:(by + 1) * p["bm"],
                       bx * p["bn"]:(bx + 1) * p["bn"]] += 1
    assert (writes[:, :m, :n] == 1).all()
    assert gy * p["bm"] - m < p["bm"] and gx * p["bn"] == n
    kt = k // Q._BK
    bounds = [b for r in p["k_tiles"] for b in r]
    assert bounds[0] == 0 and bounds[-1] == kt
    assert all(a < b for a, b in p["k_tiles"])
    assert all(p["k_tiles"][i][1] == p["k_tiles"][i + 1][0]
               for i in range(gz - 1))
    assert gz == 1 or (kt // gz >= Q._MIN_SPLIT_TILES
                       and gx * gy * gz <= Q._SMS)
    more = gz + 1
    assert (more > Q._MAX_SPLITS or kt // more < Q._MIN_SPLIT_TILES
            or gx * gy * more > Q._SMS)
    assert p["smem"] <= Q.SMEM_MAX


def test_qm_plan_at_dit_xl2():
    """DiT-XL/2's four products: proj and fc2 (1152 columns, 36 tiles of
    128 x 128) split k in 3 to run 108 blocks in one wave; qkv (108 tiles)
    and fc1 (144) do not split."""
    plans = {name: Q._qm_plan(512, k, n) for name, (k, n) in {
        "qkv": (1152, 3456), "proj": (1152, 1152), "fc1": (1152, 4608),
        "fc2": (4608, 1152)}.items()}
    assert {name: (p["bm"], p["splits"], math.prod(p["grid"]))
            for name, p in plans.items()} == {
        "qkv": (128, 1, 108), "proj": (128, 3, 108), "fc1": (128, 1, 144),
        "fc2": (128, 3, 108)}


def _walk_plan(x, w_i8, s_w, bias):
    """Kernel K7 as its plan runs it, in torch: per block, the f32 partial
    product of each split's k tiles, summed in split order, then the scale
    and the bias (two rounded f32 operations), cast to x's type."""
    m, k = x.shape
    n = w_i8.shape[1]
    p = Q._qm_plan(m, k, n)
    xb = x.to(torch.bfloat16).float()
    wf = w_i8.float()
    y = torch.full((m, n), float("nan"))
    gx, gy, _ = p["grid"]
    for by in range(gy):
        rows = slice(by * p["bm"], min(m, (by + 1) * p["bm"]))
        for bx in range(gx):
            cols = slice(bx * p["bn"], (bx + 1) * p["bn"])
            acc = None
            for k0, k1 in p["k_tiles"]:
                ks = slice(k0 * p["bk"], k1 * p["bk"])
                part = xb[rows, ks] @ wf[ks, cols]
                acc = part if acc is None else acc + part
            acc = acc * s_w[cols]
            if bias is not None:
                acc = acc + bias[cols].float()
            y[rows, cols] = acc
    return y.to(x.dtype)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(16, 8192, 128), (272, 1024, 128),
                                   (64, 1152, 256)])
def test_plan_walk_matches_reference_and_jax(m, k, n, x_dtype):
    """The plan's split-K walk against the plain version and the JAX Pallas
    kernel (interpret mode), at the tolerance of
    test_reference_matches_jax_kernel; each shape splits k."""
    assert Q._qm_plan(m, k, n)["splits"] > 1
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    jw, js = jax_quantize(jnp.asarray(w), axis=-1)
    jb = jnp.asarray(b).astype(x_dtype)
    want = np.asarray(jax_matmul_wdq(jx, jw, js.reshape(-1), jb,
                                     interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    tw = torch.from_numpy(np.array(jw))
    ts = torch.from_numpy(np.array(js).reshape(-1))
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tx.dtype)
    got = _walk_plan(tx, tw, ts, tb)
    ref = Q.matmul_wdq_reference(tx, tw, ts, tb)
    assert got.dtype == tx.dtype
    for other in (want, ref.float().numpy()):
        g = got.float().numpy()
        if x_dtype == "float32":
            np.testing.assert_allclose(g, other, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(g - other) <= 2.0 ** -7 * np.abs(other)
                    + 1e-6).all()


def test_pack_weight_is_the_fragment_order():
    """Byte ``4 j + 2 p + h`` of lane ``4 g + t`` in group ``(kb, nq)`` is
    ``w[16 kb + 8 h + 2 t + p, 32 nq + 8 j + g]``: the fragment of
    ``mma.sync m16n8k16`` / ``wgmma`` for n8 tile j (k 2t, 2t+1 and k
    2t+8, 2t+9 of column g), so that bytes 0, 2 and 1, 3 widen to its two
    bf16 pairs.  The packing is a permutation: unpacking gives w back bit
    for bit."""
    rng = np.random.default_rng(5)
    k, n = 48, 96
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    packed = Q.pack_weight(w)
    assert packed.shape == (k // 16, n // 32, 512)
    assert packed.dtype == torch.int8
    pk = packed.numpy()
    for kb, nq, g, t, j, p, h in itertools.product(
            range(k // 16), range(n // 32), range(8), range(4), range(4),
            range(2), range(2)):
        assert pk[kb, nq, (4 * g + t) * 16 + 4 * j + 2 * p + h] == \
            w[16 * kb + 8 * h + 2 * t + p, 32 * nq + 8 * j + g]
    unpacked = (packed.reshape(k // 16, n // 32, 8, 4, 4, 2, 2)
                .permute(0, 6, 3, 5, 1, 4, 2).reshape(k, n))
    assert torch.equal(unpacked, w)
    with pytest.raises(ValueError, match="int8"):
        Q.pack_weight(w[:, :40])


def _bf16_bits(x32):
    """Bits of an f32 array that bf16 holds exactly, as bf16 (uint16)."""
    u = x32.astype(np.float32).view(np.uint32)
    assert (u & 0xFFFF == 0).all()
    return (u >> 16).astype(np.uint16)


def _widen_like_kernel(words):
    """``i8x2_to_bf16x2`` of csrc/qmatmul.cu in numpy: (w & 0x007f007f) |
    0x43004300 minus (w & 0x00800080) | 0x43004300, half by half in bf16
    (the difference is exact, so an f32 subtraction gives the same bits).
    Returns the (low, high) halves' bf16 bits."""
    a = (words & 0x007F007F) | 0x43004300
    b = (words & 0x00800080) | 0x43004300

    def half(u, sh):
        return (((u >> sh) & 0xFFFF) << 16).astype(np.uint32).view(
            np.float32)
    return (_bf16_bits(half(a, 0) - half(b, 0)),
            _bf16_bits(half(a, 16) - half(b, 16)))


def test_widening_is_exact_for_every_int8():
    """The kernel's widening of an int8 pair, emulated in numpy for all
    256 x 256 pairs, in both byte positions it reads (bytes 0 and 2; 1 and
    3, shifted down by 8), equals ``w.to(bfloat16)`` bit for bit."""
    vals = np.arange(-128, 128, dtype=np.int8)
    lo, hi = (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))
    want = torch.from_numpy(vals).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    want_lo, want_hi = want[lo.astype(np.int64) + 128], \
        want[hi.astype(np.int64) + 128]
    ul = lo.view(np.uint8).astype(np.uint32)
    uh = hi.view(np.uint8).astype(np.uint32)
    junk = np.uint32(0xA5)                    # the other pair's bytes
    for words in ((ul | junk << 8 | uh << 16 | junk << 24),
                  ((junk | ul << 8 | junk << 16 | uh << 24) >> 8)):
        got_lo, got_hi = _widen_like_kernel(words.astype(np.uint32))
        np.testing.assert_array_equal(got_lo, want_lo)
        np.testing.assert_array_equal(got_hi, want_hi)


def test_qdense_remakes_the_packed_weight():
    """``QDense`` keeps ``pack_weight`` of its int8 weight beside it and
    makes both anew when its kernel changes."""
    from naturaldiffusion_tpu_torch.models.dit import QDense
    rng = np.random.default_rng(6)
    qd = QDense(128, 256)
    with torch.no_grad():
        qd.kernel.copy_(torch.from_numpy(
            rng.standard_normal((128, 256)).astype(np.float32)))
        qd.bias.zero_()
    qd.quant = "w8"
    x = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    with torch.no_grad():
        qd(x)
        w1, p1 = qd._q[0], qd._packed
        assert torch.equal(p1, Q.pack_weight(w1))
        qd(x)
        assert qd._packed is p1                   # kept while unchanged
        qd.kernel.mul_(-1.0)
        qd(x)
    assert torch.equal(qd._q[0], -w1)
    assert torch.equal(qd._packed, Q.pack_weight(qd._q[0]))
    assert not torch.equal(qd._packed, p1)
