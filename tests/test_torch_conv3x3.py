"""Port's conv3x3 / conv3x3_gn (plain versions of kernels K2 / K3) against
the JAX package's XLA conv and its fused Pallas kernel in interpret mode."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.conv3x3 import conv3x3_gn_pallas, conv3x3_xla
from naturaldiffusion_tpu_torch.ops import conv3x3 as C
from naturaldiffusion_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_gn
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

# f32: sums of 9*Cin O(1) products in another order, ~1e-6
RTOL, ATOL = 1e-5, 1e-5
# bf16 outputs: one bf16 rounding (2^-8) of O(1) values, either side
BF16_TOL = 2e-2


def _inputs(rng, b, h, w, cin, cout):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout))
          / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    pw = (1.0 + 0.2 * rng.standard_normal((b, cin))).astype(np.float32)
    pb = (0.3 * rng.standard_normal((b, cin))).astype(np.float32)
    skip = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, (pw, pb), skip


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("cin,cout", [(3, 128), (128, 128), (128, 3),
                                      (128, 256)])
def test_conv3x3_matches_xla(cin, cout):
    """Includes the 3->nf stem and the nf->3 head, which the port sends
    through the same kernel."""
    rng = np.random.default_rng(cin + cout)
    x, wt, bias, _, _ = _inputs(rng, 2, 8, 8, cin, cout)
    want = np.asarray(conv3x3_xla(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(bias)))
    before = conv3x3.launches
    got = conv3x3(_t(x), _t(wt), _t(bias)).numpy()
    assert conv3x3.launches == before
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("pre,skip,stats",
                         list(itertools.product([False, True], repeat=3)))
def test_conv3x3_gn_matches_pallas(pre, skip, stats, cout):
    rng = np.random.default_rng(8 * cout + 4 * pre + 2 * skip + stats)
    x, wt, bias, pw_pb, sk = _inputs(rng, 2, 8, 8, 128, cout)
    kw = dict(skip_rescale=skip, emit_stats=stats)
    want = conv3x3_gn_pallas(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        pre=tuple(map(jnp.asarray, pw_pb)) if pre else None,
        skip=jnp.asarray(sk) if skip else None, interpret=True, **kw)
    got = conv3x3_gn(_t(x), _t(wt), _t(bias),
                     pre=tuple(map(_t, pw_pb)) if pre else None,
                     skip=_t(sk) if skip else None, **kw)
    if not stats:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        # sums over 64 pixels of O(1) values
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=64 * ATOL)


def test_conv3x3_gn_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    x, wt, bias, pw_pb, sk = _inputs(rng, 2, 8, 8, 128, 128)
    bf = jnp.bfloat16
    want, w1, w2 = conv3x3_gn_pallas(
        jnp.asarray(x, bf), jnp.asarray(wt, bf), jnp.asarray(bias, bf),
        pre=tuple(map(jnp.asarray, pw_pb)), skip=jnp.asarray(sk, bf),
        skip_rescale=True, emit_stats=True, interpret=True)
    b16 = torch.bfloat16
    got, g1, g2 = conv3x3_gn(_t(x, b16), _t(wt, b16), _t(bias, b16),
                             pre=tuple(map(_t, pw_pb)), skip=_t(sk, b16),
                             skip_rescale=True, emit_stats=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=BF16_TOL,
                               atol=64 * BF16_TOL)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=BF16_TOL,
                               atol=64 * BF16_TOL)


def test_conv3x3_gn_pads_after_the_prologue():
    """SAME padding pads the post-SiLU activation with zeros: with a large
    ``pre_b`` the border outputs differ from padding ``silu(pre_b)``."""
    rng = np.random.default_rng(3)
    x, wt, bias, (pw, pb), _ = _inputs(rng, 1, 4, 4, 128, 128)
    pb = np.full_like(pb, 3.0)
    got = conv3x3_gn(_t(x), _t(wt), _t(bias), pre=(_t(pw), _t(pb)))
    act = torch.nn.functional.silu(_t(x) * _t(pw)[:, None, None]
                                   + _t(pb)[:, None, None])
    torch.testing.assert_close(got, conv3x3(act, _t(wt), _t(bias)),
                               rtol=RTOL, atol=ATOL)


def test_conv3x3_rejects_bad_arguments():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        conv3x3(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError):
        conv3x3_gn(x, torch.zeros(3, 3, 8, 8), skip=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError):
        conv3x3_gn(x, torch.zeros(3, 3, 8, 8),
                   pre=(torch.zeros(2, 8), torch.zeros(2, 8)))


@pytest.mark.parametrize("variant", ["tiled", "tiledew"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 128, 128),
    (1, 12, 4, 128, 256),     # tall/narrow, channel-raising
    (3, 6, 5, 128, 128),      # odd W, batch 3
])
def test_conv3x3_tiled_matches_pallas(shape, variant):
    """The plain version of K4 (which serves both TPU variants) against
    JAX's halo-tiled kernels in interpret mode, at the shapes of
    tests/test_conv3x3.py's tiled test."""
    from naturaldiffusion_tpu.ops.conv3x3 import conv3x3_pallas
    from naturaldiffusion_tpu_torch.ops.conv3x3 import conv3x3_tiled
    b, h, w, ci, co = shape
    rng = np.random.default_rng(h * w + co)
    x, wt, bias, _, _ = _inputs(rng, b, h, w, ci, co)
    want = conv3x3_pallas(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                          variant=variant, interpret=True)
    before = conv3x3_tiled.launches
    got = conv3x3_tiled(_t(x), _t(wt), _t(bias))
    assert conv3x3_tiled.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_route_predicates_match_jax(monkeypatch):
    """``pallas_conv_fits`` and ``fused_resblock_ok`` (with
    NATDIFF_PALLAS_CONV=2 on the JAX side) give the JAX package's answers
    over the maps and channel counts of the NCSN++ configs."""
    from naturaldiffusion_tpu.ops import conv3x3 as jc
    from naturaldiffusion_tpu_torch.ops import conv3x3 as tc
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    for hw in (4, 8, 16, 32, 64, 128, 256, 512):
        for cin, cout in ((128, 128), (256, 128), (128, 256), (384, 256),
                          (512, 256), (256, 256), (3, 128), (640, 512)):
            for item, jdt, tdt in ((2, jnp.bfloat16, torch.bfloat16),
                                   (4, jnp.float32, torch.float32)):
                shape = (2, hw, hw, cin)
                for v in ("valid9", "taps9", "tiled", "tiledew"):
                    assert tc.pallas_conv_fits(shape, cout, item, v) == \
                        jc.pallas_conv_fits(shape, cout, item, v)
                jx = jnp.zeros((1, 1, 1, 1), jdt)
                tx = torch.zeros(1, 1, 1, 1, dtype=tdt)
                for up in (None, 2 * hw):
                    rs = None if up is None else (2, up, up, cin)
                    assert tc.fused_resblock_ok(
                        tx, cout, shape=rs or shape) == \
                        jc.fused_resblock_ok(jx, cout, shape=rs or shape)


# --- the bf16 tensor-core kernel's tile plan ---------------------------------
# Every conv signature of a CIFAR-10 batch-64 forward and of a CelebA-HQ 256
# VE batch-4 forward (``chip_smoke.kernel_signatures`` over the full-width
# models), as (B, H, W, Cin, Cout, pre, skip, stats), and the ragged shapes:
# a map that no tile divides, a 3-channel input, a 3-channel output.
CIFAR_SIGS = [(64, *s) for s in (
    (32, 32, 3, 128, 0, 0, 0), (32, 32, 128, 3, 0, 0, 0),
    (32, 32, 128, 128, 1, 0, 1), (32, 32, 128, 128, 1, 1, 0),
    (32, 32, 256, 128, 1, 0, 1), (32, 32, 256, 256, 0, 0, 1),
    (32, 32, 256, 256, 1, 1, 0), (32, 32, 384, 128, 1, 0, 1),
    (16, 16, 128, 128, 0, 0, 1), (16, 16, 128, 128, 1, 1, 0),
    (16, 16, 128, 256, 1, 0, 1), (16, 16, 256, 256, 0, 0, 1),
    (16, 16, 256, 256, 1, 0, 1), (16, 16, 256, 256, 1, 1, 0),
    (16, 16, 384, 256, 1, 0, 1), (16, 16, 512, 256, 1, 0, 1),
    (8, 8, 256, 256, 0, 0, 1), (8, 8, 256, 256, 1, 0, 1),
    (8, 8, 256, 256, 1, 1, 0), (8, 8, 512, 256, 1, 0, 1),
    (4, 4, 256, 256, 0, 0, 1), (4, 4, 256, 256, 1, 0, 1),
    (4, 4, 256, 256, 1, 1, 0), (4, 4, 512, 256, 1, 0, 1))]
VE_SIGS = [(4, *s) for s in (
    (256, 256, 128, 3, 0, 0, 0), (256, 256, 3, 128, 0, 0, 0),
    (128, 128, 128, 3, 0, 0, 0), (64, 64, 128, 128, 0, 0, 0),
    (64, 64, 256, 3, 0, 0, 0), (32, 32, 256, 256, 0, 0, 0),
    (32, 32, 256, 3, 0, 0, 0), (16, 16, 256, 3, 0, 0, 0),
    (8, 8, 256, 3, 0, 0, 0), (4, 4, 256, 3, 0, 0, 0),
    (32, 32, 256, 256, 0, 0, 1), (32, 32, 256, 256, 1, 0, 1),
    (32, 32, 256, 256, 1, 1, 0), (16, 16, 256, 256, 0, 0, 1),
    (16, 16, 256, 256, 1, 0, 1), (16, 16, 256, 256, 1, 1, 0),
    (16, 16, 512, 256, 1, 0, 1), (8, 8, 256, 256, 0, 0, 1),
    (8, 8, 256, 256, 1, 0, 1), (8, 8, 256, 256, 1, 1, 0),
    (8, 8, 512, 256, 1, 0, 1), (4, 4, 256, 256, 0, 0, 1),
    (4, 4, 256, 256, 1, 0, 1), (4, 4, 256, 256, 1, 1, 0),
    (4, 4, 512, 256, 1, 0, 1),
    (256, 256, 128, 128, 0, 0, 0), (256, 256, 256, 128, 0, 0, 0),
    (128, 128, 128, 128, 0, 0, 0), (128, 128, 256, 128, 0, 0, 0),
    (128, 128, 256, 256, 0, 0, 0), (128, 128, 384, 128, 0, 0, 0),
    (64, 64, 128, 256, 0, 0, 0), (64, 64, 256, 256, 0, 0, 0),
    (64, 64, 384, 256, 0, 0, 0), (64, 64, 512, 256, 0, 0, 0),
    (32, 32, 512, 256, 0, 0, 0))]
RAGGED_SIGS = [(3, 20, 28, 128, 128, 1, 1, 1), (2, 32, 32, 3, 128, 0, 0, 0),
               (2, 32, 32, 128, 3, 0, 0, 0), (2, 67, 45, 128, 128, 0, 0, 0)]


def _plan_geometry(plan, b, h, w):
    """What the kernel computes from a plan, for every block x and every
    pixel slot p of its tile: the output pixel (image, row, column), whether
    it exists, and for each of the nine taps the input pixel its ldmatrix
    row reads from the staged halo (or -1 for a zero), following the
    indexing of ``csrc/conv3x3.cu:tc::conv3x3_tc_kernel``."""
    th, tw, imgs = plan["th"], plan["tw"], plan["imgs"]
    hw_t, hrow = th * tw, tw + 2
    himg = (th + 2) * hrow
    bx = np.arange(plan["grid"][0])[:, None]
    b0, h0, w0 = (np.asarray(v) for v in C.tile_origin(plan, bx))
    p = np.arange(plan["bm"])[None, :]
    ob, oh, ow = b0 + p // hw_t, h0 + p % hw_t // tw, w0 + p % tw
    valid = (ob < b) & (oh < h) & (ow < w)
    abase = (p // hw_t) * himg + (p % hw_t // tw) * hrow + p % tw
    taps = []
    for dy in range(3):
        for dx in range(3):
            r = abase + dy * hrow + dx           # the halo row this tap reads
            sb = b0 + r // himg                  # the staging of that row
            sh = h0 + r % himg // hrow - 1
            sw = w0 + r % himg % hrow - 1
            inside = (sb < b) & (sh >= 0) & (sh < h) & (sw >= 0) & (sw < w)
            taps.append(np.where(inside, (sb * h + sh) * w + sw, -1))
    return ob, oh, ow, valid, taps


@pytest.mark.parametrize("sig", CIFAR_SIGS + VE_SIGS + RAGGED_SIGS,
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_covers_each_output_once(sig):
    """The plan's blocks cover every output pixel and channel exactly once,
    each tap of each pixel reads its own neighbour (or a zero outside its
    image: a multi-image tile keeps each image's halo its own), every m16
    row tile of the mma lies in one image, and the shared memory fits."""
    b, h, w, cin, cout, pre, _, stats = sig
    plan = C._tile_plan(b, h, w, cin, cout, bool(pre), bool(stats))
    bm, bn = plan["bm"], plan["bn"]
    assert (bm, bn) == C.TILES[plan["cfg"]]
    assert plan["imgs"] * plan["th"] * plan["tw"] == bm
    assert plan["smem"] <= C.SMEM_MAX
    assert plan["halo_rows"] <= bm * 9 // 4     # the kernel's register bound
    if plan["imgs"] > 1:
        assert (plan["th"], plan["tw"]) == (h, w) and (h * w) % 16 == 0
    # channels: the grid's y blocks of bn tile [0, cout) with no block empty
    assert (plan["grid"][1] - 1) * bn < cout <= plan["grid"][1] * bn
    ob, oh, ow, valid, taps = _plan_geometry(plan, b, h, w)
    idx = ((ob * h + oh) * w + ow)[valid]
    assert np.array_equal(np.bincount(idx, minlength=b * h * w),
                          np.ones(b * h * w, np.int64))
    for k, src in enumerate(taps):
        ny, nx = oh + k // 3 - 1, ow + k % 3 - 1
        inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        want = np.where(inside, (ob * h + ny) * w + nx, -1)
        assert np.array_equal(src[valid], want[valid])
    rows = ob.reshape(ob.shape[0], -1, 16)
    assert (rows == rows[:, :, :1]).all()


def _walk_plan(x, wt, bias, pre, skip, plan):
    """The kernel's computation in torch, block by block: per chunk of
    ``bk`` input channels stage the halo (zeros outside the image), apply
    the prologue once per staged pixel, add the nine shifted products;
    then bias, skip times 1/sqrt(2), and per-(sample, channel) sums."""
    b, h, w, cin = x.shape
    cout = wt.shape[3]
    th, tw, imgs, bn, bk = (plan[k] for k in ("th", "tw", "imgs", "bn",
                                              "bk"))
    y = torch.full((b, h, w, cout), float("nan"))
    s1, s2 = torch.zeros(b, cout), torch.zeros(b, cout)
    for bx in range(plan["grid"][0]):
        b0, h0, w0 = C.tile_origin(plan, bx)
        for by in range(plan["grid"][1]):
            n0 = by * bn
            n1 = min(n0 + bn, cout)
            for i in range(imgs):
                bi = b0 + i
                if bi >= b:
                    continue
                acc = torch.zeros(th, tw, n1 - n0)
                for c0 in range(0, cin, bk):
                    c1 = min(c0 + bk, cin)
                    halo = torch.zeros(th + 2, tw + 2, c1 - c0)
                    ys, ye = max(h0 - 1, 0), min(h0 + th + 1, h)
                    xs, xe = max(w0 - 1, 0), min(w0 + tw + 1, w)
                    v = x[bi, ys:ye, xs:xe, c0:c1]
                    if pre is not None:
                        v = v * pre[0][bi, c0:c1] + pre[1][bi, c0:c1]
                        v = v / (1.0 + torch.exp(-v))
                    halo[ys - h0 + 1:ye - h0 + 1, xs - w0 + 1:xe - w0 + 1] = v
                    for dy in range(3):
                        for dx in range(3):
                            acc += (halo[dy:dy + th, dx:dx + tw]
                                    @ wt[dy, dx, c0:c1, n0:n1])
                acc = acc + bias[n0:n1]
                oh, ow = min(th, h - h0), min(tw, w - w0)
                acc = acc[:oh, :ow]
                if skip is not None:
                    acc = (acc + skip[bi, h0:h0 + oh, w0:w0 + ow, n0:n1]) \
                        * C._RSQRT2
                y[bi, h0:h0 + oh, w0:w0 + ow, n0:n1] = acc
                s1[bi, n0:n1] += acc.sum(dim=(0, 1))
                s2[bi, n0:n1] += (acc * acc).sum(dim=(0, 1))
    return y, s1, s2


@pytest.mark.parametrize("shape,kind", [
    ((6, 4, 4, 16, 16), "multi-image"),    # 4 images a tile, 2 past B
    ((2, 24, 24, 24, 40), "interior"),     # 3x3 tiles a map, one interior
    ((1, 128, 256, 8, 128), "large"),      # the 8x16 tiles of 128 x 128
    ((3, 20, 28, 128, 128), "ragged"),     # no tile divides the map
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_tile_plan_walk_matches_reference(shape, kind):
    """Walking the plan's tiles in torch gives ``conv3x3_gn_reference``'s
    output and statistics in f32 (sums in another order: 1e-5)."""
    b, h, w, cin, cout = shape
    plan = C._tile_plan(b, h, w, cin, cout, True, True)
    assert (plan["imgs"] > 1) == (kind == "multi-image")
    if kind == "large":
        assert (plan["bm"], plan["th"], plan["tw"]) == (128, 8, 16)
    if kind == "interior":
        assert plan["grid"][0] >= 9 * b
    if kind == "ragged":
        assert h % plan["th"] and w % plan["tw"]
    rng = np.random.default_rng(b * h * w + cout)
    x, wt, bias, pw_pb, sk = _inputs(rng, b, h, w, cin, cout)
    x, wt, bias, sk = _t(x), _t(wt), _t(bias), _t(sk)
    pre = tuple(map(_t, pw_pb))
    got = _walk_plan(x, wt, bias, pre, sk, plan)
    want = C.conv3x3_gn_reference(x, wt, bias, pre=pre, skip=sk,
                                  skip_rescale=True, emit_stats=True)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=1e-5, atol=1e-5 * (
            1 if g.dim() == 4 else h * w))
