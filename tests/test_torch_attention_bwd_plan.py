"""The plan of K9's and K10's backward (``ops/attention.py:_bwd_plan``) and
the arithmetic of its wgmma pass (``csrc/attention_bwd.cu``, bf16 at head
dims 64 and 72), here on the CPU: which path each type and head dim takes,
that the tiles divide what ``wgmma`` and TMA need (D = 72's padding
included), the scratch and shared-memory sizes, what the wrapper refuses,
and the pass's decomposition walked in torch (key blocks of 128 in two
warpgroups of 64, query tiles of 64 with lse padded by +inf, dq summed in
the f32 scratch in the kernel's fragment order and read back by the
post-pass's index map) against the plain backward and ``jax.grad`` of the
JAX package's ``mha``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.ops.attention import mha as jax_mha
from naturaldiffusion_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# float32 on both sides, sums in other orders; relative L2 of each gradient
TOL = 1e-5
BF = torch.bfloat16
# (b, h, t, d): DiT-XL/2's train step, SD3's joint lengths, and lengths of
# one query, one short of a query tile, one past a key block, unaligned
PLAN_SHAPES = [(32, 16, 256, 72), (2, 24, 4429, 64), (2, 24, 4250, 64),
               (2, 24, 4096, 64), (1, 1, 1, 64), (2, 3, 63, 72),
               (2, 3, 129, 64), (2, 3, 201, 72), (2, 3, 201, 16),
               (2, 3, 201, 32)]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("b,h,t,d", PLAN_SHAPES)
def test_bwd_plan_routes_and_tiles(b, h, t, d, dtype):
    """bf16 at d 64 and 72 takes the wgmma pass, bf16 at 16 and 32 the
    mma.sync kernels, f32 the FMA kernels; the wgmma pass's tiles are what
    wgmma and TMA take, its grid covers every key once, its scratch and
    shared memory are the kernel's."""
    p = A._bwd_plan(b, h, t, d, dtype)
    assert p == A._bwd_plan(b, h, t, d, dtype)            # pure
    assert p["launches"] == 3
    gx, gy = p["grid"]
    assert gy == b * h
    keys = np.zeros(gx * p["bkv"], np.int64)
    for bx in range(gx):
        keys[bx * p["bkv"]:(bx + 1) * p["bkv"]] += 1
    assert (keys[:t] == 1).all() and len(keys) - t < p["bkv"]
    if dtype == torch.float32:
        assert p["path"] == "fma" and (p["bkv"], p["bq"]) == (32, 32)
        assert p["work"] == b * h * t and p["smem"] == 0
        return
    if d <= 32:
        assert p["path"] == "mma" and (p["bkv"], p["bq"]) == (64, 64)
        assert p["work"] == b * h * t and p["smem"] == 0
        return
    assert p["path"] == "wgmma"
    # two consumer warpgroups of 64 keys (wgmma's M); query tiles of 64:
    # the M of the dQ product and 4 k16 steps of the dV / dK products
    assert p["bkv"] == 2 * 64 and p["bq"] == 64 and p["bq"] % 16 == 0
    # reductions over D in k16 steps (72 -> 80), D as an n dimension in
    # n8 steps, a row in TMA boxes of 64 bf16 (one 128-byte swizzle row)
    assert p["dk"] % 16 == 0 and p["dk"] - d < 16 and d % 8 == 0
    assert p["dk"] == (80 if d == 72 else 64)
    assert p["boxes"] * 64 >= p["dk"] and (p["boxes"] - 1) * 64 < d
    assert p["stages"] >= 2
    assert p["tp"] % p["bq"] == 0 and 0 <= p["tp"] - t < p["bq"]
    assert p["work"] == b * h * p["tp"] * (d + 2)
    kv, qt = p["boxes"] * 128 * p["bkv"], p["boxes"] * 128 * p["bq"]
    assert p["smem"] == (1024 + 2 * kv + 2 * p["stages"] * qt
                         + 2 * 64 * 128 + 2 * p["bq"] * d * 4
                         + 2 * p["stages"] * p["bq"] * 4
                         + (2 * p["stages"] + 1) * 8)
    assert p["smem"] <= 232_448


def test_bwd_plan_at_the_path_shapes():
    """DiT-XL/2's train step: 2 key blocks a head, 1024 blocks; SD3's
    joint length: 35 key blocks a head, 70 query tiles each."""
    p = A._bwd_plan(32, 16, 256, 72, BF)
    assert p["grid"] == (2, 512) and p["boxes"] == 2 and p["tp"] == 256
    p = A._bwd_plan(2, 24, 4429, 64, BF)
    assert p["grid"] == (35, 48) and p["tp"] == 4480 and p["boxes"] == 1


@pytest.mark.parametrize("shape", [(1, 1, 0, 64), (0, 2, 8, 64),
                                   (2, 2, 8, 48), (300, 300, 8, 64)])
def test_bwd_plan_refuses(shape):
    with pytest.raises(ValueError, match="no plan"):
        A._bwd_plan(*shape, BF)
    with pytest.raises(ValueError, match="no plan"):
        A._bwd_plan(2, 2, 8, 64, torch.float16)


def test_launch_bwd_refuses_before_any_launch():
    """The wrapper checks types, head dims and shapes before it touches
    the card (these CPU tensors never reach a launch)."""
    q = torch.zeros(1, 2, 8, 64, dtype=BF)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A._launch_bwd(q.half(), q.half(), q.half(), q.half(), q.half(), lse,
                      0.125, "t")
    with pytest.raises(ValueError, match="one type"):
        A._launch_bwd(q, q, q.float(), q, q, lse, 0.125, "t")
    q48 = torch.zeros(1, 2, 8, 48, dtype=BF)
    with pytest.raises(ValueError, match="head dims"):
        A._launch_bwd(q48, q48, q48, q48, q48, lse, 0.125, "t")
    with pytest.raises(ValueError, match="lse"):
        A._launch_bwd(q, q, q, q, q, lse[:, :, :4], 0.125, "t")


def test_tma_stride_check():
    """The DiT's strided views go to the tensor maps in place; a
    broadcast (stride 0) or an unaligned row start takes a copy."""
    qkv = torch.zeros(2, 256, 3, 16, 72, dtype=BF)
    q = qkv[:, :, 0].transpose(1, 2)
    assert A._tma_ok(q) and A._kernel_strides(q, q, q) is not None
    wide = torch.zeros(1, 1, 8, 64, dtype=BF).expand(2, 3, 8, 64)
    assert wide.stride()[:2] == (0, 0) and not A._tma_ok(wide)
    odd = torch.zeros(2, 3, 8, 65, dtype=BF)[..., 1:]
    assert not A._tma_ok(odd)


# ---- the wgmma pass walked in torch ----------------------------------------

def _frag_index(r, c):
    """Where the main kernel stages element (row r, column c) of a 64-row
    tile's dq part: 16 bytes a thread (chunk j = c / 8, warp w = r / 16,
    lane 4 g + t with g = r % 8, t = (c % 8) / 2), value 2 hh + c % 2 for
    rows g + 8 hh."""
    j, w, g, hh, t = c // 8, r // 16, r % 8, (r // 8) % 2, (c % 8) // 2
    return ((j * 4 + w) * 32 + 4 * g + t) * 4 + 2 * hh + c % 2


def _post_pass(acc, b, h, t, d, tp, scale):
    """``bwd_dq_kernel``'s map: one 16-byte entry of the scratch to rows
    i and i + 8, columns c and c + 1 of dq."""
    dq = torch.full((b, h, t, d), float("nan"))
    ent = acc.reshape(-1, 4)
    per_tile = 64 * d // 4
    for idx in range(ent.shape[0]):
        e, tile = idx % per_tile, idx // per_tile
        bh, r0 = divmod(tile, tp // 64)
        lane, w, j = e & 31, (e >> 5) & 3, e >> 7
        i, c = r0 * 64 + 16 * w + (lane >> 2), 8 * j + 2 * (lane & 3)
        bi, hi = divmod(bh, h)
        if i < t:
            dq[bi, hi, i, c:c + 2] = ent[idx, :2] * scale
        if i + 8 < t:
            dq[bi, hi, i + 8, c:c + 2] = ent[idx, 2:] * scale
    return dq


def _walk(q, k, v, o, do, lse, scale):
    """The pass as its plan runs it, in float32: the pre-pass (delta, lse
    log2 e padded with +inf, the scratch zeroed), then per key block and
    warpgroup every query tile (p by exp2, keys past t zeroed, dS), dv and
    dk in registers, each dq part added into the scratch in fragment
    order; then the post-pass."""
    b, h, t, d = q.shape
    p = A._bwd_plan(b, h, t, d, BF)
    tp, l2e = p["tp"], 1.0 / math.log(2.0)
    acc = torch.zeros(b * h * tp * d)
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    pad = torch.zeros((b, h, tp, d))

    def padded(x):
        out = pad.clone()
        out[:, :, :t] = x
        return out
    qp, dop = padded(q), padded(do)
    kp = torch.zeros((b, h, p["grid"][0] * p["bkv"], d))
    vp = torch.zeros_like(kp)
    kp[:, :, :t], vp[:, :, :t] = k, v
    delta = torch.zeros((b, h, tp))
    delta[:, :, :t] = (do * o).sum(-1)
    lse2 = torch.full((b, h, tp), math.inf)
    lse2[:, :, :t] = lse * l2e
    idx = torch.tensor([[_frag_index(r, c) for c in range(d)]
                        for r in range(64)])
    for y in range(p["grid"][1]):
        bi, hi = divmod(y, h)
        for bx in range(p["grid"][0]):
            for wg in range(2):
                k0 = bx * p["bkv"] + 64 * wg
                keys = torch.arange(k0, k0 + 64)
                kt, vt = kp[bi, hi, keys], vp[bi, hi, keys]
                adv, adk = torch.zeros(64, d), torch.zeros(64, d)
                for i in range(tp // 64):
                    qs = slice(64 * i, 64 * i + 64)
                    st = kt @ qp[bi, hi, qs].T                    # S^T
                    dpt = vt @ dop[bi, hi, qs].T                  # dP^T
                    pt = torch.exp2(st * scale * l2e
                                    - lse2[bi, hi, qs][None])
                    pt[keys >= t] = 0.0
                    dst = pt * (dpt - delta[bi, hi, qs][None])
                    adv += pt @ dop[bi, hi, qs]
                    adk += dst @ qp[bi, hi, qs]
                    part = dst.T @ kt                             # dQ part
                    base = (y * tp + 64 * i) * d
                    acc.index_add_(0, base + idx.flatten(), part.flatten())
                live = keys < t
                dk[bi, hi, keys[live]] = adk[live] * scale
                dv[bi, hi, keys[live]] = adv[live]
    return _post_pass(acc, b, h, t, d, tp, scale), dk, dv


def test_fragment_order_round_trip():
    """Every element of a 64-row tile has its own staged slot, and the
    post-pass reads it back to its row and column (d 64 and 72)."""
    for d in (64, 72):
        slots = sorted(_frag_index(r, c) for r in range(64) for c in range(d))
        assert slots == list(range(64 * d))
        x = torch.randn(1, 1, 64, d)
        acc = torch.zeros(64 * d)
        acc[[_frag_index(r, c) for r in range(64) for c in range(d)]] = \
            x.flatten()
        torch.testing.assert_close(_post_pass(acc, 1, 1, 64, d, 64, 1.0), x)


@pytest.mark.parametrize("t,d", [(200, 64), (130, 72), (64, 72), (5, 64)])
def test_wgmma_walk_matches_plain_and_jax(t, d):
    """The pass's walk (float32) against the plain backward and
    ``jax.grad`` of JAX's ``mha(backend="xla")``, f32, ragged t."""
    rng = np.random.default_rng(t + d)
    q, k, v, do = (rng.standard_normal((1, 2, t, d)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    s = tq @ tk.transpose(-1, -2) * scale
    o = torch.softmax(s, -1) @ tv
    lse = torch.logsumexp(s, -1)
    got = _walk(tq, tk, tv, o, tdo, lse, scale)
    want = A.attention_backward_reference(tq, tk, tv, o, tdo, lse, scale)

    def f(q_, k_, v_):
        return jnp.sum(jax_mha(q_, k_, v_, backend="xla") * do)
    jgrads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                             for a in (q, k, v)))
    for g, w, j in zip(got, want, jgrads):
        assert not torch.isnan(g).any()
        err = float((g - w).norm() / w.norm())
        jerr = float((g - torch.from_numpy(np.array(j))).norm() / w.norm())
        assert err < TOL and jerr < TOL, (err, jerr)


def test_ablation_patches_apply_to_the_kernel():
    """``attention_bwd_ablation.py``'s patches name text the kernel's
    source holds (each clock stamp's anchor once), and without a card it
    refuses to run."""
    import attention_bwd_ablation as ab
    from naturaldiffusion_tpu_torch.ops import _cuda
    src = (_cuda.CSRC / "attention_bwd.cu").read_text()
    for name, (patches, _) in ab.PATCHES.items():
        for old, new in patches:
            assert old in src and old != new, name
        assert ab.patched(src, name) != src
    text = src
    for old, _ in ab._STAMPS[2:]:
        assert text.count(old) == 1, old
    if not torch.cuda.is_available():
        assert ab.main([]) == 2
