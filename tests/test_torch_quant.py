"""The port's int8 quantization (``ops/quant.py``) against the JAX
package's on the CPU: the mode switch, the int8 operands byte for byte
(half steps and the +-127 clip included), the int8 convs in every mode, the
kernel's plan at every CIFAR and VE shape (tiles, split-K, shared memory,
the blocks' walk), its split-K partition and its dynamic quantize's
arithmetic in plain torch and numpy, and the weight cache of the model's
layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops import quant as jq
from naturaldiffusion_tpu_torch.models import layers as L
from naturaldiffusion_tpu_torch.ops import quant as tq
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.detach().to(torch.float32).numpy() if t.is_floating_point() \
        else t.numpy()


def _pair(a, dt):
    """The same values as a torch tensor and a JAX array of type ``dt``."""
    tdt, jdt = DTYPES[dt]
    t = torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    return t, jnp.asarray(_np(t)).astype(jdt)


def _x(rng, shape, scale=2.0):
    """Activations with exact half steps for the scale 1 (amax 127) and
    values past the clip: k + 0.5 for k in -130..130, then noise."""
    a = scale * rng.standard_normal(shape).astype(np.float32)
    half = np.arange(-130, 131, dtype=np.float32) + 0.5
    flat = a.reshape(-1)
    flat[:half.size] = half[: flat.size]
    return a


@pytest.mark.parametrize("value", ["", "int8", "int8_all", "int8_static",
                                   "int8_all_static", "w8", "int4"])
def test_quant_enabled_matches_jax(monkeypatch, value):
    monkeypatch.setenv("NATDIFF_QUANT", value)
    assert tq.quant_enabled() == jq.quant_enabled()
    monkeypatch.delenv("NATDIFF_QUANT")
    assert tq.quant_enabled() is None and jq.quant_enabled() is None


@pytest.mark.parametrize("value", [None, "6.0", "3.5", "127"])
def test_static_amax_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("NATDIFF_QUANT_AMAX", raising=False)
    else:
        monkeypatch.setenv("NATDIFF_QUANT_AMAX", value)
    assert tq.static_amax() == jq.static_amax()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("per_sample", [True, False])
def test_quantize_act_bytes_equal_jax(dt, per_sample):
    """Dynamic: sample 0's amax is 127 exactly (scale 1), so its k + 0.5
    values are half steps, rounded to even; the others are noise."""
    rng = np.random.default_rng(0)
    a = _x(rng, (3, 6, 5, 16))
    a[0] = np.clip(a[0], -127, 127)
    a[0, 0, 0, 0] = 127.0
    a[1] *= 40.0
    t, j = _pair(a, dt)
    got_q, got_s = tq.quantize_act(t, per_sample)
    want_q, want_s = jq.quantize_act(j, per_sample)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if per_sample:
        # round half to even, not away from zero
        assert int(got_q[0].reshape(-1)[0]) == round(float(a.reshape(-1)[0]))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("amax", [127.0, 6.0, 1.0])
def test_quantize_act_static_bytes_equal_jax(dt, amax):
    """Static, with amax 127 (scale 1: k + 0.5 are half steps, +-130.5
    clip), 6.0 (the default) and 1.0 (most values clip)."""
    t, j = _pair(_x(np.random.default_rng(1), (2, 7, 9, 32)), dt)
    got_q, got_s = tq.quantize_act_static(t, amax)
    want_q, want_s = jq.quantize_act_static(j, amax)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s == want_s
    assert int(got_q.max()) <= 127 and int(got_q.min()) >= -127
    if amax == 127.0:
        assert {-127, 127} <= set(got_q.unique().tolist())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 3, 128, 256), (384, 128), (3, 3, 3, 8)])
def test_quantize_weight_bytes_equal_jax(dt, shape):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shape).astype(np.float32) * 0.05
    a.reshape(-1)[:8] = [0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -3.0, 0.25]
    t, j = _pair(a, dt)
    got_q, got_s = tq.quantize_weight(t)
    want_q, want_s = jq.quantize_weight(j)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _conv_inputs(dt, seed=3, shape=(2, 6, 8, 128), cout=128):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.standard_normal(shape)).astype(np.float32) * 3.0
    w = rng.standard_normal((3, 3, shape[3], cout)).astype(np.float32) * 0.03
    b = 0.1 * rng.standard_normal(cout).astype(np.float32)
    return _pair(x, dt), _pair(w, dt), _pair(b, dt)


# the dequant is two f32 roundings in the port; XLA on the CPU contracts
# some of its multiply-adds into FMAs and not others (measured: 20-25 % of
# elements of a jitted ``y * s + b`` equal the FMA's value), so the f32
# outputs may differ by one rounding of the product: 2 f32 ulps of the
# output's magnitude bound it; in bf16 the same difference flips a bf16
# rounding in rare elements, one bf16 ulp
ULPS = {"float32": 2 * 2.0 ** -23, "bfloat16": 2.0 ** -8}


def _close_to_rounding(got, want, dt):
    got = _np(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    lim = ULPS[dt] * np.maximum(np.abs(want), 1e-30)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= lim + 1e-37).all(), \
        float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["dynamic", "per_tensor", "static"])
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_int8_matches_jax(dt, mode, bias):
    """The int32 sums equal JAX's s8 conv exactly (checked through the
    operands and an int32 conv); the output within one dequant rounding."""
    (xt, xj), (wt, wj), (bt, bj) = _conv_inputs(dt)
    amax = 6.0 if mode == "static" else None
    per_sample = mode != "per_tensor"
    got = tq.conv3x3_int8(xt, wt, bt if bias else None,
                          per_sample=per_sample, act_amax=amax)
    want = jq.conv3x3_int8(xj, wj, bj if bias else None,
                           per_sample=per_sample, act_amax=amax)
    assert got.dtype == xt.dtype and got.shape == (2, 6, 8, 128)
    _close_to_rounding(got, want, dt)
    # the int32 sums of the plain version, against JAX's s8 conv on the
    # same int8 operands
    xq = (tq.quantize_act_static(xt, amax)[0] if amax
          else tq.quantize_act(xt, per_sample)[0])
    wq = tq.quantize_weight(wt)[0]
    acc_t = torch.nn.functional.conv2d(
        xq.permute(0, 3, 1, 2).double(), wq.permute(3, 2, 0, 1).double(),
        padding=1).permute(0, 2, 3, 1).to(torch.int32)
    acc_j = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (2, 16, 128)])
def test_conv1x1_int8_matches_jax(dt, mode, shape):
    """A [1,1,Cin,Cout] kernel on an NHWC map and a [Cin,Cout] NIN matrix
    on tokens."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    wshape = (1, 1, 128, 256) if len(shape) == 4 else (128, 256)
    w = rng.standard_normal(wshape).astype(np.float32) * 0.05
    b = 0.1 * rng.standard_normal(256).astype(np.float32)
    (xt, xj), (wt, wj), (bt, bj) = _pair(x, dt), _pair(w, dt), _pair(b, dt)
    amax = 6.0 if mode == "static" else None
    got = tq.conv1x1_int8(xt, wt, bt, act_amax=amax)
    want = jq.conv1x1_int8(xj, wj, bj, act_amax=amax)
    assert got.shape == shape[:-1] + (256,) and got.dtype == xt.dtype
    _close_to_rounding(got, want, dt)


def test_conv3x3_int8_exact_on_grid():
    """Integers in [-127, 127] through an identity tap come back exactly
    (``tests/test_quant.py``'s check, on the port)."""
    x = torch.randint(-127, 128, (1, 6, 6, 128)).float()
    x[0, 0, 0, 0] = 127.0
    w = torch.zeros(3, 3, 128, 128)
    w[1, 1] = torch.eye(128)
    torch.testing.assert_close(tq.conv3x3_int8(x, w), x, rtol=0, atol=1e-5)


def test_pack_conv_weight_layout():
    w = torch.randint(-127, 128, (3, 3, 128, 256), dtype=torch.int8)
    p = tq.pack_conv_weight(w)
    assert p.shape == (9, 256, 128) and p.is_contiguous()
    for tap, ci, co in ((0, 0, 0), (4, 17, 200), (8, 127, 255)):
        assert p[tap, co, ci] == w[tap // 3, tap % 3, ci, co]


# every 3x3 int8 conv of the CIFAR batch-64 unfused walk, the VE batch-4
# walk's large maps, and 2-image maps the CPU tests run
PLAN_SHAPES = [(64, 32, 32, 128, 128), (64, 32, 32, 256, 128),
               (64, 16, 16, 128, 256), (64, 16, 16, 256, 256),
               (64, 16, 16, 512, 256), (64, 16, 16, 384, 256),
               (64, 8, 8, 256, 256), (64, 8, 8, 512, 256),
               (64, 4, 4, 256, 256), (64, 4, 4, 512, 256),
               (4, 256, 256, 128, 128), (4, 256, 256, 256, 128),
               (4, 128, 128, 128, 256), (4, 128, 128, 384, 256),
               (4, 64, 64, 256, 256), (2, 8, 8, 128, 128),
               (1, 4, 4, 128, 128), (3, 20, 28, 128, 256)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_int8_plan_covers_every_pixel(shape):
    """The kernel's plan: each output pixel in exactly one block row of the
    grid, the halo within the kernel's bound (9/4 BM rows), the shared
    memory within the card's 232,448 bytes, one block per 128 output
    channels (or 64)."""
    from naturaldiffusion_tpu_torch.ops import conv3x3 as C
    b, h, w, cin, cout = shape
    p = tq._int8_plan(b, h, w, cin, cout)
    assert p["smem"] <= tq.SMEM_MAX
    assert p["halo_rows"] <= p["bm"] * 9 // 4
    assert p["imgs"] * p["th"] * p["tw"] == p["bm"]
    assert p["grid"][1] * p["bn"] == cout
    seen = np.zeros((b, h, w), np.int64)
    for bx in range(p["grid"][0]):
        i0, r0, c0 = C.tile_origin(p, bx)
        seen[i0:i0 + p["imgs"], r0:r0 + p["th"], c0:c0 + p["tw"]] += 1
    assert (seen == 1).all()
    # the same plan the entry checks, as ints
    assert tq._plan_ints(b, h, w, cin, cout)[-1] == p["smem"]


def test_int8_plan_refuses_unaligned_channels():
    with pytest.raises(ValueError, match="multiples of 128"):
        tq._int8_plan(2, 8, 8, 96, 128)
    with pytest.raises(ValueError, match="multiples of 128"):
        tq._int8_plan(2, 8, 8, 128, 3)


def test_weight_cache_follows_the_parameter(monkeypatch):
    """The int8 weight of a ``PConv3x3`` is made at its first int8 call,
    reused while the parameter is unchanged, and remade (into the same
    tensors) after an in-place change, a ``load``-style copy or a change
    of the activations' type."""
    monkeypatch.setenv("NATDIFF_QUANT", "int8_static")
    conv = L.PConv3x3(128, 128)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 4, 128)
    y0 = conv(x)
    held = conv._q8[1]
    assert conv(x) is not None and conv._q8[1] is held
    with torch.no_grad():
        conv.kernel.mul_(-1.0)
    y1 = conv(x)
    assert conv._q8[1] is held                 # rebuilt in place
    np.testing.assert_array_equal(held[0].numpy(),
                                  tq.quantize_weight(conv.kernel)[0].numpy())
    torch.testing.assert_close(y1, -y0 + 2 * conv.bias, rtol=0, atol=1e-5)
    with torch.no_grad():
        conv.kernel.copy_(torch.zeros_like(conv.kernel))
    torch.testing.assert_close(conv(x), conv.bias.expand(1, 4, 4, 128),
                               rtol=0, atol=0)
    conv.to(torch.bfloat16)                    # new storage, new type
    assert conv(x.to(torch.bfloat16)).dtype == torch.bfloat16
    assert conv._q8[0][1] == torch.bfloat16


@pytest.mark.parametrize("cls", ["NIN", "PConv1x1"])
def test_wide_modes_quantize_the_1x1_products(monkeypatch, cls):
    """``int8_all*`` take the 1x1 products onto int8 (``int8`` and
    ``int8_static`` leave them float), and their output equals
    ``conv1x1_int8`` on the same weights."""
    mod = L.NIN(128, 256) if cls == "NIN" else L.PConv1x1(128, 256)
    mod.reset_parameters(torch.Generator().manual_seed(1))
    w = mod.W if cls == "NIN" else mod.kernel
    b = mod.b if cls == "NIN" else mod.bias
    x = torch.randn(2, 4, 4, 128)
    monkeypatch.setenv("NATDIFF_QUANT", "int8_static")
    torch.testing.assert_close(mod(x), x @ w.reshape(128, 256) + b)
    assert mod._q8 is None
    monkeypatch.setenv("NATDIFF_QUANT", "int8_all_static")
    torch.testing.assert_close(mod(x), tq.conv1x1_int8(x, w, b, act_amax=6.0),
                               rtol=0, atol=0)
    assert mod._q8 is not None


def test_kernel_route_refuses_what_it_cannot_run():
    """The CUDA wrapper's checks run before any launch: f32 activations
    and misshapen packed weights raise (no card needed to reach them)."""
    x = torch.zeros(1, 4, 4, 128)
    wk = torch.zeros(9, 128, 128, dtype=torch.int8)
    sw = torch.ones(128)
    with pytest.raises(ValueError, match="bfloat16"):
        tq._launch(x, wk, sw, None, None, 6.0)
    with pytest.raises(ValueError, match="packed weight"):
        tq._launch(x.bfloat16(), wk[:, :, :64], sw, None, None, 6.0)


def _divisors_to_4(n):
    return [s for s in range(2, tq._MAX_SPLITS + 1) if n % s == 0]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_int8_plan_fits_and_fills_the_card(shape):
    """Tile, split, weight ring and halo buffers fit the card's 232,448
    bytes; the split divides the channel chunks; the launch reaches
    ``_MIN_BLOCKS`` blocks (a persistent one capped at one an SM) wherever
    the units or a split of at most ``_MAX_SPLITS`` can, and takes the
    most splits where none can."""
    from naturaldiffusion_tpu_torch.ops.conv3x3 import _MIN_BLOCKS
    b, h, w, cin, cout = shape
    p = tq._int8_plan(b, h, w, cin, cout)
    assert p["smem"] == tq._int8_smem(p["halo_rows"]) <= tq.SMEM_MAX
    assert p["stages"] == tq._STAGES
    assert p["chunks"] == cin // tq._BK and p["chunks"] % p["splits"] == 0
    assert p["units"] == p["grid"][0] * p["grid"][1]
    if p["units"] >= _MIN_BLOCKS:
        assert p["splits"] == 1
        assert p["blocks"] == min(p["units"], tq._SMS)
    else:
        assert p["blocks"] == p["units"] * p["splits"]
        can = [s for s in _divisors_to_4(p["chunks"])
               if p["units"] * s >= _MIN_BLOCKS]
        assert p["splits"] == (min(can) if can else
                               max(_divisors_to_4(p["chunks"]), default=1))


@pytest.mark.parametrize("shape", PLAN_SHAPES + [(64, 8, 8, 384, 256),
                                                 (3, 4, 4, 256, 256)])
def test_int8_block_walk_covers_every_unit_chunk_once(shape):
    """The kernel's walk (block ``b``: cluster rank ``b % splits`` sums
    chunks ``rank * kc / splits ..``, units ``b / splits``, then every
    ``blocks / splits``-th) takes each (unit, input-channel chunk) exactly
    once, and a split's blocks are one cluster on one unit."""
    b, h, w, cin, cout = shape
    p = tq._int8_plan(b, h, w, cin, cout)
    s, kcs = p["splits"], p["chunks"] // p["splits"]
    assert p["blocks"] % s == 0
    seen = np.zeros((p["units"], p["chunks"]), np.int64)
    for blk in range(p["blocks"]):
        rank, u0, ustep = blk % s, blk // s, p["blocks"] // s
        units = list(range(u0, p["units"], ustep))
        if s > 1:
            assert units == [u0]          # one unit per cluster
        for u in units:
            seen[u, rank * kcs:(rank + 1) * kcs] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 512, 128), (3, 8, 8, 256, 128),
                                   (1, 6, 10, 384, 128)])
def test_int8_split_k_partition_equals_reference(mode, shape):
    """The split-K partition of the plan in plain torch: each split's int32
    partial sums over its input-channel chunks, added, then the dequant,
    equal ``conv3x3_int8_reference`` bit for bit."""
    b, h, w, cin, cout = shape
    p = tq._int8_plan(b, h, w, cin, cout)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_x(rng, (b, h, w, cin))).to(torch.bfloat16)
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                          .astype(np.float32) / 40.0)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                            / 10.0).to(torch.bfloat16)
    w_i8, s_w, _ = tq.quantize_conv_weight(wt.to(torch.bfloat16))
    amax = 6.0 if mode == "static" else None
    x_i8, sx = tq._act(x, True, amax)
    assert p["splits"] > 1
    kcs = p["chunks"] // p["splits"]
    acc = torch.zeros((b, h, w, cout), dtype=torch.int32)
    for r in range(p["splits"]):
        c = slice(r * kcs * tq._BK, (r + 1) * kcs * tq._BK)
        part = torch.nn.functional.conv2d(
            x_i8[..., c].permute(0, 3, 1, 2).double(),
            w_i8[:, :, c].permute(3, 2, 0, 1).double(), padding=1)
        acc += part.permute(0, 2, 3, 1).to(torch.int32)
    got = tq._dequant(acc, sx, s_w, bias, x.dtype)
    want = tq.conv3x3_int8_reference(x, w_i8, s_w, bias, act_amax=amax)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_dynamic_quantize_fast_path_equals_the_division():
    """The kernel's dynamic quantize (``quantize_div`` in
    ``csrc/conv3x3_int8.cu``) in float32 numpy, step for step: ``q = f *
    rcp`` with ``rcp`` the correctly rounded ``1 / d``, ``rint(q)`` unless
    ``q`` lies within 2^-14 of a half-integer, then the division.  For
    every finite bf16 ``f`` and scales ``d`` of every kind it equals
    ``clip(rint(f / d))`` with the IEEE quotient, and at random scales it
    divides for under 1 in 1000 of the values ``|f| <= amax``."""
    bits = np.arange(2 ** 16, dtype=np.uint32) << 16
    f = bits.view(np.float32)
    f = f[np.isfinite(f)]
    rng = np.random.default_rng(3)
    amax = np.concatenate([
        rng.uniform(0.01, 20.0, 60), 2.0 ** rng.integers(-20, 20, 20),
        np.nextafter(np.float32(2.0 ** np.arange(-8, 8)), np.float32(0)),
        [1e-30, 1.0, 127.0, 6.0, 3.3895314e38]]).astype(np.float32)
    d_all = np.maximum(amax, np.float32(1e-30)) / np.float32(127.0)
    slow = realistic = 0
    with np.errstate(over="ignore", invalid="ignore"):
        for k, d in enumerate(d_all.astype(np.float32)):
            rcp = np.float32(1.0) / d
            q = f * rcp
            fast = np.abs(q - np.floor(q) - np.float32(0.5)) > np.float32(2 ** -14)
            exact = f / d
            got = np.where(fast, q, exact)
            clip = lambda v: np.clip(np.nan_to_num(np.rint(v), nan=0.0,
                                                   posinf=127, neginf=-127),
                                     -127, 127)
            np.testing.assert_array_equal(clip(got), clip(exact))
            if k < 60:  # random scales, |f| <= amax as the dynamic scales hold
                live = np.abs(f) <= amax[k]
                slow += int((~fast & live).sum())
                realistic += int(live.sum())
    assert slow < 1e-3 * realistic


def test_int8_ablation_patches_apply_to_the_kernel():
    """``int8_ablation.py``'s patches name text the kernel's source holds,
    and without a card it refuses to run."""
    import int8_ablation as ab
    from naturaldiffusion_tpu_torch.ops import _cuda
    src = (_cuda.CSRC / "conv3x3_int8.cu").read_text()
    for name, (patches, _) in ab.PATCHES.items():
        for old, new in patches:
            assert src.count(old) == 1, name
            assert old != new
    if not torch.cuda.is_available():
        assert ab.main([]) == 2
