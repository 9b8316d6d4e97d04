"""Port's GroupNorm maths against the JAX package's (f32, CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops import group_norm as jgn
from naturaldiffusion_tpu_torch.ops import group_norm as tgn
import torch_port_util  # noqa: F401  binds torch's CPU math first

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


# --- kernel K6's plan and its order of summation ------------------------------
# The plan covers [B, H, W, C] in units of whole groups; the C entry of
# csrc/group_norm.cu refuses a plan that disagrees with its constants, and
# the CUDA kernel runs on the card only (chip_smoke.py).  Here the plan is
# walked in Python and the kernel's summation order in torch.

THREADS = tgn._THREADS

# the distinct K6 shapes (groups) of one batch-4 forward of the full-width
# CelebA-HQ 256 VE NCSN++ (its 19 signatures differ in act and extra bias
# too, which the plan does not read) and of one batch-64 CIFAR-10 forward's
# standalone GroupNorms
VE_K6 = [(4, 256, 256, 128), (4, 256, 256, 256), (4, 128, 128, 128),
         (4, 128, 128, 256), (4, 128, 128, 384), (4, 64, 64, 128),
         (4, 64, 64, 256), (4, 64, 64, 384), (4, 64, 64, 512),
         (4, 32, 32, 256), (4, 16, 16, 256), (4, 8, 8, 256), (4, 4, 4, 256)]
CIFAR_K6 = [(64, 32, 32, 128), (64, 16, 16, 256), (64, 8, 8, 256),
            (64, 4, 4, 256)]
RAGGED_K6 = [((1, 7, 5, 12), 3), ((3, 7, 5, 12), 3), ((1, 7, 5, 16), 4),
             ((2, 7, 5, 16), 4)]
PLAN_CASES = ([(s, 32) for s in VE_K6 + CIFAR_K6] + RAGGED_K6)


def _rects(plan, b, hw, c):
    """(sample, p0, p1, c0, c1) of every CTA (on-chip) or block (streamed)
    of the plan's launches, as the C entry lays out its grids."""
    out, span = [], plan["span"]
    if plan["form"] == "grid":
        for bb, _, c0 in plan["chunks"]:
            for blk in range(plan["grid"][0]):
                out.append((bb, blk * span, min(hw, (blk + 1) * span), c0,
                            c0 + plan["slice"]))
        return out
    if plan["form"] == "onchip":
        k, cs = plan["cluster"], plan["slice"]
        for bx in range(plan["grid"][0]):
            for bb in range(b):
                p0 = (bx % k) * span
                out.append((bb, p0, min(hw, p0 + span), (bx // k) * cs,
                            (bx // k + 1) * cs))
        return out
    tile = plan["tile"]
    for b0, nb, c0 in plan["chunks"]:
        for sx in range(-(-hw // span)):
            for ty in range(plan["slice"] // tile):
                for z in range(nb):
                    out.append((b0 + z, sx * span, min(hw, (sx + 1) * span),
                                c0 + ty * tile, c0 + (ty + 1) * tile))
    return out


def _assert_tiles_once(rects, b, hw, c):
    """Every (sample, pixel, channel) in exactly one rectangle: counted on
    the grid of all rectangle edges."""
    ps = sorted({0, hw} | {r[1] for r in rects} | {r[2] for r in rects})
    cs = sorted({0, c} | {r[3] for r in rects} | {r[4] for r in rects})
    assert ps[0] == 0 and ps[-1] == hw and cs[0] == 0 and cs[-1] == c
    pi = {v: i for i, v in enumerate(ps)}
    ci = {v: i for i, v in enumerate(cs)}
    cnt = np.zeros((b, len(ps) - 1, len(cs) - 1), np.int32)
    for bb, p0, p1, c0, c1 in rects:
        assert 0 <= bb < b and p0 <= p1 and c0 < c1
        cnt[bb, pi[p0]:pi[p1], ci[c0]:ci[c1]] += 1
    assert (cnt == 1).all()


def _assert_threads_cover(n_pix, rows, nq, step):
    """Thread r * nq + q of a CTA or block takes channel vector q of pixels
    r, r + rows, ... (``step`` = rows, or rows * UNROLL loads an iteration
    in the streamed form): each (pixel, vector) once."""
    assert rows * nq <= THREADS
    cnt = np.zeros((n_pix, nq), np.int32)
    for r in range(rows):
        for p0 in range(r, n_pix, step):
            for u in range(step // rows):
                if p0 + u * rows < n_pix:
                    cnt[p0 + u * rows, :] += 1
    assert (cnt == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape,groups", PLAN_CASES)
@pytest.mark.parametrize("form", [None, "grid", "streamed"])
def test_gn_plan_covers_each_element_once(shape, groups, itemsize, form):
    b, h, w, c = shape
    hw, gs = h * w, c // groups
    plan = tgn._gn_plan(b, h, w, c, groups, itemsize, form)
    if form is None:
        # the 256 x 256 maps take the whole card a unit; every other shape
        # is held by clusters
        assert plan["form"] == ("grid" if hw == 256 * 256 else "onchip")
    else:
        assert plan["form"] == form
    vb, cs = plan["vec_bytes"], plan["slice"]
    assert vb in (2, 4, 8, 16) and vb % itemsize == 0
    assert (c * itemsize) % vb == 0 and (cs * itemsize) % vb == 0
    assert cs % gs == 0 and c % cs == 0           # units of whole groups
    v = vb // itemsize
    assert plan["nq"] * plan["rows"] <= THREADS
    assert plan["rows"] == THREADS // plan["nq"]
    assert plan["smem"] <= tgn.SMEM_MAX
    if plan["form"] == "onchip":
        assert plan["cluster"] in (1, 2, 4, 8) and plan["launches"] == 1
        assert plan["nq"] * v == cs and plan["span"] == -(-hw // plan["cluster"])
        assert plan["span"] * cs * itemsize <= plan["smem"]
        if shape in VE_K6 + CIFAR_K6:   # a 32-byte sector a pixel at least
            assert vb == 16 and cs * itemsize >= 32
        _assert_threads_cover(min(plan["span"], hw), plan["rows"],
                              plan["nq"], plan["rows"])
    elif plan["form"] == "grid":
        assert plan["grid"][0] <= tgn._SMS and plan["launches"] == 2
        assert plan["nq"] * v == cs and plan["span"] == -(-hw // tgn._SMS)
        assert plan["span"] * cs * itemsize <= plan["smem"]
        assert len(plan["chunks"]) == b * (c // cs)
        assert plan["scratch"] == 6 * cs + 1
        if hw == 256 * 256:       # a sample's 128 channels (64 in f32) a unit
            assert cs * itemsize == 256 and vb == 16
        _assert_threads_cover(min(plan["span"], hw), plan["rows"],
                              plan["nq"], plan["rows"])
    else:
        tile = plan["tile"]
        assert plan["nq"] * v == tile and cs % tile == 0
        assert plan["cluster"] == 1 and plan["smem"] <= 48 * 1024
        assert plan["launches"] == 1 + 2 * len(plan["chunks"])
        chunk = plan["samples"] * hw * cs * itemsize
        assert chunk <= tgn._L2_CHUNK or cs == gs
        _assert_threads_cover(min(plan["span"], hw), plan["rows"],
                              plan["nq"], plan["rows"] * tgn._UNROLL)
    _assert_tiles_once(_rects(plan, b, hw, c), b, hw, c)
    ints, words = tgn._plan_ints(b, h, w, c, groups, itemsize, form)
    assert ints == (tgn.FORMS.index(plan["form"]), vb, cs, plan["tile"],
                    plan["cluster"], plan["samples"], plan["span"],
                    plan["smem"])
    assert words == plan["scratch"]


def test_gn_plan_refuses_what_no_form_takes():
    with pytest.raises(ValueError):       # a 256 x 256 unit exceeds a cluster
        tgn._gn_plan(4, 256, 256, 128, 32, 2, "onchip")
    with pytest.raises(ValueError):       # one group of 16 f32 channels at
        tgn._gn_plan(1, 2048, 2048, 32, 2, 4, "grid")   # 4 M pixels: 256 MB
    assert tgn._gn_plan(1, 2048, 2048, 32, 2, 4)["form"] == "streamed"
    with pytest.raises(ValueError):
        tgn._gn_plan(4, 8, 8, 30, 4, 2)
    with pytest.raises(ValueError):
        tgn._gn_plan(4, 8, 8, 32, 4, 8)


def _fma32(a, f):
    """float32 ``fmaf(f, f, a)``: one rounding of the exact value."""
    return (a.double() + f.double() * f.double()).float()


def _tree(red, nrow):
    """The kernel's pairwise tree over the first ``nrow`` rows of ``red``."""
    half = 1
    while half < nrow:
        half *= 2
    half //= 2
    while half >= 1:
        for r in range(half):
            if r + half < nrow:
                red[r] = red[r] + red[r + half]
        half //= 2
    return red[0]


def _block_sums(seg, nq, v):
    """One CTA's (or block's) channel sums of ``seg [pixels, nq * v]`` f32 in
    the kernel's order: thread r * nq + q adds its pixels r, r + rows, ...
    in order, then xor shuffles and a tree over the warps (nq divides 32)
    or a tree over the rows."""
    rows = THREADS // nq
    width = nq * v
    n = seg.shape[0]
    a1 = torch.zeros(rows, width)
    a2 = torch.zeros(rows, width)
    for p in range(n):
        a1[p % rows] = a1[p % rows] + seg[p]
        a2[p % rows] = _fma32(a2[p % rows], seg[p])
    if 32 % nq == 0:
        # per thread in thread order: [THREADS, v]
        t1 = a1.reshape(rows * nq, v)
        t2 = a2.reshape(rows * nq, v)
        idx = torch.arange(THREADS)
        o = nq
        while o < 32:
            t1 = t1 + t1[idx ^ o]
            t2 = t2 + t2[idx ^ o]
            o *= 2
        w1 = t1.reshape(THREADS // 32, 32, v)[:, :nq].reshape(-1, width)
        w2 = t2.reshape(THREADS // 32, 32, v)[:, :nq].reshape(-1, width)
        return _tree(w1.clone(), THREADS // 32), _tree(w2.clone(),
                                                        THREADS // 32)
    return _tree(a1.clone(), rows), _tree(a2.clone(), rows)


def _fold_apply(x, s1, s2, scale, bias, groups, eps, act, tb):
    """The kernel's fold (group members summed in order, the extra bias
    entering algebraically) and affine, in float32."""
    b, h, w, c = x.shape
    gs, n_sp = c // groups, float(h * w)
    if tb is not None:
        t = tb.float().expand(b, c)
        s2 = (s2 + (2.0 * t) * s1) + (n_sp * t) * t
        s1 = s1 + n_sp * t
    sg = torch.zeros(b, groups)
    s2g = torch.zeros(b, groups)
    for k in range(gs):
        sg = sg + s1[:, k::gs]
        s2g = s2g + s2[:, k::gs]
    n = n_sp * gs
    mu = sg / n
    var = s2g / n - mu * mu
    inv = torch.rsqrt(var + eps)
    wc = inv.repeat_interleave(gs, 1) * scale.float()
    bc = bias.float() - mu.repeat_interleave(gs, 1) * wc
    if tb is not None:
        bc = bc + t * wc
    y = x.float() * wc[:, None, None] + bc[:, None, None]
    if act == "silu":
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y.to(x.dtype)


def k6_walk(x, scale, bias, groups, eps, act, tb, plan):
    """Kernel K6 in torch, in the order its plan gives: per-CTA sums, the
    cluster's totals added in rank order (on-chip), or the blocks' sums
    added in block order (grid and streamed, where the card's atomics take
    any order); then the fold and the affine."""
    b, h, w, c = x.shape
    hw = h * w
    xf = x.float().reshape(b, hw, c)
    v = plan["vec_bytes"] // x.element_size()
    s1, s2 = torch.zeros(b, c), torch.zeros(b, c)
    parts = {}
    for bb, p0, p1, c0, c1 in _rects(plan, b, hw, c):
        nq = (c1 - c0) // v
        r1, r2 = _block_sums(xf[bb, p0:p1, c0:c1], nq, v)
        parts.setdefault((bb, c0, c1), []).append((r1, r2))
    for (bb, c0, c1), pr in parts.items():
        for r1, r2 in pr:
            s1[bb, c0:c1] = s1[bb, c0:c1] + r1
            s2[bb, c0:c1] = s2[bb, c0:c1] + r2
    return _fold_apply(x, s1, s2, scale, bias, groups, eps, act, tb)


WALK_CASES = [((2, 8, 8, 32), 8, "silu", "BC"), ((1, 7, 5, 12), 3, None, "1C"),
              ((2, 7, 5, 16), 4, "silu", None), ((2, 6, 6, 48), 4, None, "BC")]


@functools.lru_cache(maxsize=None)
def _jax_gn(shape, groups, act, eb, dtype):
    rng = np.random.default_rng(sum(shape) + groups)
    x = (1.0 + rng.standard_normal(shape)).astype(np.float32)
    c = shape[-1]
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tb = (0.5 * rng.standard_normal((shape[0] if eb == "BC" else 1, c))
          ).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    jtb = None if eb is None else jnp.broadcast_to(jnp.asarray(tb, jdt),
                                                   (shape[0], c))
    args = (jx, jnp.asarray(scale), jnp.asarray(bias), groups)
    want = jgn.group_norm_pallas(*args, act=act, extra_bias=jtb,
                                 interpret=True)
    ref = jgn.group_norm_reference(*args, act=act, extra_bias=jtb)
    # the inputs as the kernel sees them: x and tb in x's type
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
            torch.from_numpy(bias),
            None if eb is None else torch.from_numpy(tb).to(tdt).float(),
            np.asarray(want, np.float32), np.asarray(ref, np.float32))


# f32: sums in another order than JAX's (~1e-7 relative), as TOL; bf16:
# the walk and JAX round nearly equal f32 values to bf16, one step (2^-8
# relative, values up to ~4) apart at most, as K6_TOL
WALK_TOL = {"f32": TOL, "bf16": K6_TOL["bf16"]}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form,cluster", [("onchip", None), ("onchip", 2),
                                          ("onchip", 8), ("streamed", None),
                                          ("grid", None)])
@pytest.mark.parametrize("shape,groups,act,eb", WALK_CASES)
def test_k6_walk_matches_jax(shape, groups, act, eb, form, cluster, dtype):
    """The kernel's order of summation (per-CTA sums, the cluster exchange
    in rank order, the group fold), walked in torch in every form and at
    cluster sizes 1-8, against ``group_norm_pallas(interpret=True)`` and
    ``group_norm_reference``."""
    x, scale, bias, tb, want, ref = _jax_gn(shape, groups, act, eb, dtype)
    b, h, w, c = shape
    # the grid form on a card of 40 SMs: more blocks than pixels at the
    # smaller shapes
    plan = tgn._gn_plan(b, h, w, c, groups, x.element_size(), form, sms=40)
    if cluster is not None:                   # a wider cluster, same units
        plan = dict(plan, cluster=cluster, span=-(-h * w // cluster),
                    grid=(cluster * (c // plan["slice"]), b, 1))
    _assert_tiles_once(_rects(plan, b, h * w, c), b, h * w, c)
    got = k6_walk(x, scale, bias, groups, 1e-6, act, tb, plan).float()
    tol = WALK_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
