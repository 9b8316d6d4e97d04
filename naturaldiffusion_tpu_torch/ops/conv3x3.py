"""3x3 / stride-1 / SAME NHWC convolution and the fused resblock conv
(port of ``naturaldiffusion_tpu/ops/conv3x3.py``).

* :func:`conv3x3` — ``x [B,H,W,Cin] * w [3,3,Cin,Cout] + b``: kernel K2
  (``_conv_kernel`` on the TPU).  Any channel count: the model's 3->nf stem
  and nf->3 head go through it too.
* :func:`conv3x3_tiled` — the same function as :func:`conv3x3` for large
  maps, kernel K4 (``_conv_tiled_kernel``), which also serves K5
  (``_conv_tiledew_kernel``): the two TPU kernels compute one function and
  differ only in how VMEM is filled.
* :func:`conv3x3_gn` — the fused resblock conv, kernel K3
  (``_conv_gn_kernel``): prologue ``silu(x * pre_w + pre_b)`` rounded to x's
  type (GroupNorm collapsed by ``ops.group_norm.gn_affine_coeffs``), the
  conv, bias, optional skip-add times 1/sqrt(2), and optionally the
  per-(sample, channel) sum and sum of squares of the f32 result, which the
  next GroupNorm needs.

All run kernels of ``csrc/conv3x3.cu`` for a CUDA tensor and
:func:`conv3x3_gn_reference` for a CPU one.  The plain version accumulates
in float32 like the kernels: the prologue output is rounded to x's type,
then the conv runs on float32 copies of the operands.  In bfloat16 every
call runs one tensor-core kernel whose tiles :func:`_tile_plan` chooses
here; float32 runs the SIMT kernels.

K2, K3 and K4 are differentiable (:class:`_ConvFn`, under grad mode with an
input that requires grad): the forward is the kernel (or the plain version
on the CPU), the backward the vector-Jacobian product of
:func:`conv3x3_twin`, the kernels' function in library ops, on the saved
inputs (:func:`twin_vjp`: cuDNN's data and weight gradients on the card),
as the JAX package's ``conv3x3_pallas`` and ``_fused_with_vjp`` take XLA
backwards (``:896``, ``:732``).

* :func:`conv3x3_library` — the same function as :func:`conv3x3` by one
  ``F.conv2d`` on channels-last views in the input's type (cuDNN on the
  card), the counterpart of the JAX package's ``conv3x3_xla`` (``:885``):
  the route of every non-int8 3x3 conv under ``NATDIFF_PALLAS_CONV=0``.

The route switch is the JAX package's (``:60-110``), read per call:
:func:`pallas_conv_enabled` and :func:`fused_resblock_enabled` read
``NATDIFF_PALLAS_CONV`` (``1``: the conv kernels; ``2``: also the fused
resblock), :func:`default_variant` ``NATDIFF_CONV_VARIANT`` (``taps9``)
and :func:`tiled_variant` ``NATDIFF_CONV_TILED`` (``tiled``; ``tiled`` and
``tiledew`` both run K4).  The same variables with the same values, so
one environment sets both packages.  One default differs: the port's
``NATDIFF_PALLAS_CONV`` is ``2`` (its main path, the fused resblock),
JAX's ``0``; the port bench sets JAX's (``apps/bench.py``).
``models/layers.py:PConv3x3`` takes JAX's order: fused (K3), the int8
conv (``ops.quant``), the kernels K2/K4 under ``1``/``2``, else
:func:`conv3x3_library`.

The route predicates :func:`fused_resblock_ok` and :func:`pallas_conv_fits`
are the JAX package's, copied with their constants (``:76``, ``:115-198``):
those constants describe a TPU's VMEM, and serve here only so that every
resblock takes the form the JAX package gives it (fused, or unfused with
the whole-image or the halo-tiled conv).  Whether the card prefers other
routes is a question for measurements, not for these numbers.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from . import _cuda
from ._autograd import needs_grad

_RSQRT2 = 0.7071067811865476
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plan's arguments: cfg, imgs, th, tw, bk, stages, grid_x, grid_y,
# smem, vec_x, vec_w
_PLAN_ARGS = 11
# natdiff_conv3x3_tiled(dtype, x, w, b, y, B, H, W, Cin, Cout, plan...,
# stream)
_TILED_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * (5 + _PLAN_ARGS) + [ctypes.c_void_p])
# natdiff_conv3x3(dtype, has_pre, has_skip, emit_stats, x, w, b, pre_w,
# pre_b, skip, scale, y, s1, s2, B, H, W, Cin, Cout, plan..., stream)
_CONV_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                  + [ctypes.c_float] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * (5 + _PLAN_ARGS) + [ctypes.c_void_p])

# --- the bf16 tensor-core kernel's tile plan ---------------------------------
# constants of csrc/conv3x3.cu's namespace tc (the entry checks them): BK
# input channels per chunk, the weight ring's stages, the halo row stride
# (bf16)
_BK, _STAGES, _SA = 64, 3, 72
SMEM_MAX = 232_448          # dynamic shared memory a block may use
# (BM output pixels, BN output channels) of the kernel's instances, by cfg
TILES = ((128, 128), (64, 128), (64, 64))
# blocks a launch should reach before a larger tile is taken: about one
# per SM of the card's 132
_MIN_BLOCKS = 128


def _spatial_tile(bm, hh, ww):
    """(images, rows, columns) of a block's ``bm`` pixels: several whole
    images where an image is a multiple of 16 pixels (each m16 row tile of
    the mma then lies in one image) at least 4 x 4, else a 2-D tile of one
    image, 16 columns wide where the map is wider than 8."""
    hw = hh * ww
    if hh >= 4 and ww >= 4 and hw % 16 == 0 and bm % hw == 0:
        return bm // hw, hh, ww
    tw = 16 if bm >= 128 and ww > 8 else 8
    return 1, bm // tw, tw


def _tile_plan(bsz, hh, ww, cin, cout, has_pre=False, emit_stats=False):
    """The bf16 kernel's launch for ``[bsz, hh, ww, cin] -> cout``: the
    largest tile (``TILES``) whose grid reaches ``_MIN_BLOCKS`` blocks (the
    smallest where none does; 64 output channels where ``cout <= 64``), its
    spatial tile, grid and dynamic shared memory.  Pure: the CPU tests walk
    it, and the C entry checks it against its own constants."""
    cfgs = [c for c, (_, bn) in enumerate(TILES) if bn == 64 or cout > 64]
    for cfg in cfgs:
        bm, bn = TILES[cfg]
        imgs, th, tw = _spatial_tile(bm, hh, ww)
        tiles_h, tiles_w = -(-hh // th), -(-ww // tw)
        grid = (-(-bsz // imgs) * tiles_h * tiles_w, -(-cout // bn))
        if grid[0] * grid[1] >= _MIN_BLOCKS:
            break
    halo = imgs * (th + 2) * (tw + 2)
    smem = (2 * halo * _SA * 2 + _STAGES * _BK * (bn + 8) * 2
            + (2 * imgs * cin * 4 if has_pre else 0)
            + (2 * imgs * bn * 4 if emit_stats else 0)
            + -(-5 * halo // 16) * 16)         # per halo row: source, image
    if smem > SMEM_MAX or grid[1] > 65535:
        raise ValueError(f"conv3x3: no tile plan for {(bsz, hh, ww, cin)} -> "
                         f"{cout} ({smem} B of shared memory)")
    return dict(cfg=cfg, bm=bm, bn=bn, imgs=imgs, th=th, tw=tw,
                tiles_h=tiles_h, tiles_w=tiles_w, halo_rows=halo, bk=_BK,
                stages=_STAGES, grid=grid, smem=smem)


def tile_origin(plan, bx):
    """(first image, first row, first column) of block ``bx`` of a plan,
    as the kernel reads its ``blockIdx.x``."""
    tx = bx % plan["tiles_w"]
    ty = bx // plan["tiles_w"] % plan["tiles_h"]
    gi = bx // (plan["tiles_w"] * plan["tiles_h"])
    return gi * plan["imgs"], ty * plan["th"], tx * plan["tw"]


@functools.lru_cache(maxsize=512)
def _plan_ints(bsz, hh, ww, cin, cout, has_pre, emit_stats):
    """:func:`_tile_plan` as the C entries take it, cached: a launch costs
    host time that the small maps' kernels do not hide."""
    p = _tile_plan(bsz, hh, ww, cin, cout, has_pre, emit_stats)
    return (p["cfg"], p["imgs"], p["th"], p["tw"], p["bk"], p["stages"],
            *p["grid"], p["smem"])


def _plan_args(x, w, pre, emit_stats):
    """The C entries' plan arguments; zeros for float32, whose SIMT kernels
    take none."""
    if x.dtype != torch.bfloat16:
        return (0,) * _PLAN_ARGS
    bsz, hh, ww, cin = x.shape
    cout = w.shape[3]
    vec_x = cin % 8 == 0 and x.data_ptr() % 16 == 0
    vec_w = cout % 8 == 0 and w.data_ptr() % 16 == 0
    return (*_plan_ints(bsz, hh, ww, cin, cout, pre is not None,
                        bool(emit_stats)), vec_x, vec_w)


def conv3x3_gn_reference(x, w, b=None, *, pre=None, skip=None,
                         skip_rescale=False, emit_stats=False):
    """Plain version of both kernels (see the module docstring)."""
    xin = x
    if pre is not None:
        xf = (x.to(torch.float32) * pre[0][:, None, None, :]
              + pre[1][:, None, None, :])
        # SiLU written out as the kernel computes it
        xin = (xf / (1.0 + torch.exp(-xf))).to(x.dtype)
    acc = F.conv2d(xin.to(torch.float32).permute(0, 3, 1, 2),
                   w.to(torch.float32).permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    if b is not None:
        acc = acc + b.to(torch.float32)
    if skip is not None:
        acc = acc + skip.to(torch.float32)
        if skip_rescale:
            acc = acc * _RSQRT2
    y = acc.to(x.dtype)
    if not emit_stats:
        return y
    return y, acc.sum(dim=(1, 2)), (acc * acc).sum(dim=(1, 2))


def _check(x, w, b, pre, skip):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"weight {tuple(w.shape)} does not match input "
                         f"{tuple(x.shape)}")
    bsz, hh, ww, cin = x.shape
    cout = w.shape[3]
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"bias {tuple(b.shape)} != ({cout},)")
    if skip is not None and tuple(skip.shape) != (bsz, hh, ww, cout):
        raise ValueError(f"skip {tuple(skip.shape)} != output "
                         f"{(bsz, hh, ww, cout)}")
    if pre is not None:
        for t in pre:
            if tuple(t.shape) != (bsz, cin):
                raise ValueError(f"pre coeffs {tuple(t.shape)} != "
                                 f"{(bsz, cin)}")
    ts = [t for t in (x, w, b, skip, *(pre or ())) if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _check_launch(x, w, b, pre, skip, what):
    """Raise on anything the CUDA kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    same = [t for t in (w, b, skip) if t is not None]
    if any(t.dtype != x.dtype for t in same):
        raise ValueError(f"{what}: x, w, b and skip must share one dtype")
    if pre is not None and any(t.dtype != torch.float32 for t in pre):
        raise ValueError(f"{what}: pre coefficients must be float32")
    ts = [t for t in (x, w, b, skip, *(pre or ())) if t is not None]
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    bsz, hh, ww, cin = x.shape
    if bsz * hh * ww * max(cin, w.shape[3]) >= 2 ** 31:
        raise ValueError(f"{what}: tensor too large for the kernel's indexing")


def _launch(x, w, b, pre, skip, skip_rescale, emit_stats, what):
    """Launch the CUDA kernel K2 or K3."""
    _check_launch(x, w, b, pre, skip, what)
    bsz, hh, ww, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((bsz, hh, ww, cout), dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if emit_stats:       # one zeroed buffer: one fill launch, not two
        s1, s2 = torch.zeros((2, bsz, cout), dtype=torch.float32,
                             device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _cuda.entry("conv3x3", "natdiff_conv3x3", _CONV_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_DTYPES[x.dtype], pre is not None, skip is not None,
                 bool(emit_stats), x.data_ptr(), w.data_ptr(), ptr(b),
                 ptr(pre[0] if pre else None), ptr(pre[1] if pre else None),
                 ptr(skip), _RSQRT2 if skip_rescale else 1.0, y.data_ptr(),
                 ptr(s1), ptr(s2), bsz, hh, ww, cin, cout,
                 *_plan_args(x, w, pre, emit_stats), _cuda.stream_ptr(x))
    _cuda.check("conv3x3", err, what)
    return (y, s1, s2) if emit_stats else y


def _acc_type(x):
    """The twin's accumulation type: float32, or x's where wider (float64
    in the tests), as JAX's ``promote_types(x, float32)``."""
    return torch.promote_types(x.dtype, torch.float32)


def _prologue(x, pw, pb):
    """``(xf, sigmoid(xf))`` of the prologue's pre-activation ``xf = x *
    pre_w + pre_b`` in the accumulation type."""
    xf = x.to(_acc_type(x)) * pw[:, None, None, :] + pb[:, None, None, :]
    return xf, torch.sigmoid(xf)


def _twin_acc(xin, w, b, skip, skip_rescale):
    """The twin's accumulator (:func:`_acc_type`): ``F.conv2d`` on
    channels-last views in xin's type (cuDNN on the card), then bias, skip
    and 1/sqrt(2)."""
    wcl = w.to(xin.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    at = _acc_type(xin)
    acc = F.conv2d(xin.permute(0, 3, 1, 2), wcl, padding=1).permute(
        0, 2, 3, 1).to(at)
    if b is not None:
        acc = acc + b.to(at)
    if skip is not None:
        acc = acc + skip.to(at)
        if skip_rescale:
            acc = acc * _RSQRT2
    return acc


def conv3x3_twin(x, w, b=None, pre=None, skip=None, skip_rescale=False,
                 emit_stats=False):
    """The kernels' function in library ops (the JAX package's
    ``_fused_reference_xla`` and ``conv3x3_xla``, ``ops/conv3x3.py:690,
    885``): the prologue ``xf * sigmoid(xf)`` of ``xf = x*pre_w + pre_b``
    in float32 rounded to x's type, ``F.conv2d`` on channels-last views in
    x's type, then bias, skip, 1/sqrt(2) and the channel sums in float32.
    The backward of K2, K3 and K4 (:class:`_ConvFn`) is this function's
    vector-Jacobian product."""
    xin = x
    if pre is not None:
        xf, sig = _prologue(x, *pre)
        xin = (xf * sig).to(x.dtype)
    acc = _twin_acc(xin, w, b, skip, skip_rescale)
    y = acc.to(x.dtype)
    if not emit_stats:
        return y
    return y, acc.sum(dim=(1, 2)), (acc * acc).sum(dim=(1, 2))


def _conv_grads(g, xin, w, need_x, need_w):
    """(d xin, d w) of ``conv(xin, w)`` for the output cotangent ``g`` in
    xin's type: one ``aten.convolution_backward`` on channels-last views
    (cuDNN's data and weight gradients on the card)."""
    wcl = w.to(xin.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xin.permute(0, 3, 1, 2), wcl, None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [need_x, need_w, False])
    return (None if gx is None else gx.permute(0, 2, 3, 1),
            None if gw is None else gw.permute(2, 3, 1, 0))


def twin_vjp(inputs, grads, needs, skip_rescale=False):
    """The cotangents of ``(x, w, b, pre_w, pre_b, skip)`` (``inputs``,
    None where absent) for the cotangents ``grads`` of ``(y, s1, s2)``
    (None where an output took none) of :func:`conv3x3_twin`, written out:
    float32 ``d acc = dy + ds1 + 2 acc ds2`` (``acc`` recomputed only where
    s2 takes a cotangent), the skip's and 1/sqrt(2)'s, the bias's sum, the
    conv's data and weight gradients in x's type (:func:`_conv_grads`), and
    the prologue's ``silu'(xf)``, ``x`` and 1.  ``needs[i]``: input i
    wants one (the rest come back None)."""
    x, w, b, pw, pb, skip = inputs
    gy, gs1, gs2 = (tuple(grads) + (None, None))[:3]
    f32 = _acc_type(x)
    xin, xf = x, None
    if pw is not None:
        xf, sig = _prologue(x, pw, pb)
        xin = (xf * sig).to(x.dtype)
    gacc = None if gy is None else gy.to(f32)
    for g, term in ((gs1, lambda: 1.0), (gs2, lambda: 2.0 * _twin_acc(
            xin, w, b, skip, skip_rescale))):
        if g is not None:
            add = term() * g[:, None, None, :]
            gacc = add if gacc is None else gacc + add
    if gacc is None:
        return (None,) * 6
    if skip is not None and skip_rescale:
        gacc = gacc * _RSQRT2
    nx, nw, nb, npw, npb, nskip = needs
    gxin, gw = _conv_grads(gacc.to(x.dtype), xin, w,
                           bool(nx or npw or npb), bool(nw))
    gx = gpw = gpb = None
    if xf is not None and (nx or npw or npb):
        gxf = gxin.to(f32) * (sig * (1.0 + xf * (1.0 - sig)))
        gx = (gxf * pw[:, None, None, :]).to(x.dtype) if nx else None
        gpw = (gxf * x.to(f32)).sum(dim=(1, 2)) if npw else None
        gpb = gxf.sum(dim=(1, 2)) if npb else None
    elif nx:
        gx = gxin
    return (gx, None if gw is None else gw.to(w.dtype),
            gacc.sum(dim=(0, 1, 2)).to(b.dtype) if nb else None, gpw, gpb,
            gacc.to(skip.dtype) if nskip else None)


class _ConvFn(torch.autograd.Function):
    """K2, K3 or K4 in the graph: ``run(x, w, b, pre_w, pre_b, skip)`` is
    the forward (the kernel on the card, the plain version on the CPU);
    the backward is :func:`twin_vjp` on the saved inputs, taking a
    cotangent for each output (``y``, and ``s1``, ``s2`` with
    ``emit_stats``) and giving one to each input."""

    @staticmethod
    def forward(ctx, run, skip_rescale, emit_stats, *inputs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.skip_rescale = skip_rescale
        return run(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *twin_vjp(
            ctx.saved_tensors, grads, ctx.needs_input_grad[3:],
            ctx.skip_rescale))


def _call(run, x, w, b, pre, skip, skip_rescale=False, emit_stats=False):
    """``run`` directly, or through :class:`_ConvFn` where autograd needs
    it."""
    pw, pb = pre if pre is not None else (None, None)
    if needs_grad(x, w, b, pw, pb, skip):
        return _ConvFn.apply(run, skip_rescale, emit_stats, x, w, b, pw, pb,
                             skip)
    return run(x, w, b, pw, pb, skip)


def conv3x3(x, w, b=None):
    """Stride-1 SAME 3x3 conv, NHWC: ``x [B,H,W,Cin] * w [3,3,Cin,Cout]
    (+ b [Cout])``, f32 accumulation, output in x's type.  A CPU tensor
    takes the plain version; a CUDA tensor takes kernel K2 or raises.
    Differentiable (:class:`_ConvFn`)."""
    _check(x, w, b, None, None)
    if x.device.type == "cpu":
        return _call(_plain, x, w, b, None, None)
    return _call(_run_k2, x, w, b, None, None)


def _plain(x, w, b, pw, pb, skip, skip_rescale=False, emit_stats=False):
    return conv3x3_gn_reference(x, w, b, pre=None if pw is None else (pw, pb),
                                skip=skip, skip_rescale=skip_rescale,
                                emit_stats=emit_stats)


def _run_k2(x, w, b, pw, pb, skip):
    y = _launch(x, w, b, None, None, False, False, "conv3x3")
    conv3x3.launches += 1
    return y


def _run_k4(x, w, b, pw, pb, skip):
    _check_launch(x, w, b, None, None, "conv3x3_tiled")
    bsz, hh, ww, cin = x.shape
    if bsz > 65535:                         # the grid's z dimension
        raise ValueError(f"conv3x3_tiled takes at most 65535 images, got "
                         f"{bsz}")
    cout = w.shape[3]
    y = torch.empty((bsz, hh, ww, cout), dtype=x.dtype, device=x.device)
    fn = _cuda.entry("conv3x3", "natdiff_conv3x3_tiled", _TILED_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(), bsz, hh,
                 ww, cin, cout, *_plan_args(x, w, None, False),
                 _cuda.stream_ptr(x))
    _cuda.check("conv3x3", err, "conv3x3_tiled")
    conv3x3_tiled.launches += 1
    return y


def conv3x3_tiled(x, w, b=None):
    """:func:`conv3x3` for the large maps that the JAX package sends to its
    halo-tiled kernels: the same function, from kernel K4 on a CUDA tensor
    (contiguous float32 or bfloat16; raises on anything else) and from the
    plain version on a CPU one.  Differentiable, with K2's backward."""
    _check(x, w, b, None, None)
    if x.device.type == "cpu":
        return _call(_plain, x, w, b, None, None)
    return _call(_run_k4, x, w, b, None, None)


def conv3x3_gn(x, w, b=None, *, pre=None, skip=None, skip_rescale=False,
               emit_stats=False):
    """Fused resblock conv: ``y = conv3x3(silu(x*pre_w + pre_b)) (+ b)
    (+ skip) (* 1/sqrt2)``, and with ``emit_stats`` also ``(sum, sumsq)``
    of y's f32 value over H, W as float32 [B, Cout].

    ``pre`` is ``(pre_w, pre_b)``, float32 [B, Cin].  A CPU tensor takes
    the plain version; a CUDA tensor takes kernel K3 or raises.
    Differentiable in every input, with cotangents taken on every output
    (:class:`_ConvFn`)."""
    _check(x, w, b, pre, skip)
    if x.device.type == "cpu":
        run = functools.partial(_plain, skip_rescale=skip_rescale,
                                emit_stats=emit_stats)
    else:
        def run(x, w, b, pw, pb, skip):
            out = _launch(x, w, b, None if pw is None else (pw, pb), skip,
                          skip_rescale, emit_stats, "conv3x3_gn")
            conv3x3_gn.launches += 1
            return out
    return _call(run, x, w, b, pre, skip, skip_rescale, emit_stats)


conv3x3.launches = 0
conv3x3_tiled.launches = 0
conv3x3_gn.launches = 0


def conv3x3_library(x, w, b=None):
    """:func:`conv3x3`'s function by PyTorch's library: ``F.conv2d`` on the
    NCHW views of NHWC ``x`` (channels-last, so cuDNN runs its NHWC
    kernels on the card) in x's type, then ``+ b``, as the JAX package's
    ``conv3x3_xla`` adds its bias after the conv.  The route of the
    non-int8 3x3 convs under ``NATDIFF_PALLAS_CONV=0``; no kernel of this
    package."""
    _check(x, w, b, None, None)
    wcl = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), wcl, padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if b is None else y + b.to(x.dtype)


# --- the JAX package's route switch (ops/conv3x3.py:60-110), per call -------
def _conv_flag() -> str:
    return os.environ.get("NATDIFF_PALLAS_CONV", "2")


def pallas_conv_enabled() -> bool:
    """``NATDIFF_PALLAS_CONV`` in ``1``, ``2``: the 3x3 convs run the
    kernels K2/K4 (the port's default ``2``; JAX's default is ``0``)."""
    return _conv_flag() in ("1", "2")


def fused_resblock_enabled() -> bool:
    """``NATDIFF_PALLAS_CONV == 2``: the resblocks may take the fused
    form (kernel K3)."""
    return _conv_flag() == "2"


def default_variant() -> str:
    """The whole-image formulation whose fit :func:`large_map` asks
    (``NATDIFF_CONV_VARIANT``, ``taps9``); K2 serves each of them."""
    return os.environ.get("NATDIFF_CONV_VARIANT", "taps9")


def tiled_variant() -> str:
    """The large-map formulation (``NATDIFF_CONV_TILED``, ``tiled``): the
    port runs K4 for ``tiled`` and ``tiledew`` alike, one function."""
    return os.environ.get("NATDIFF_CONV_TILED", "tiled")


# --- the JAX package's route predicates (ops/conv3x3.py:76, :115-198) -------
# per-grid-step VMEM budget of the tiled variants, and the whole-image cap
_VMEM_BUDGET = 10 * 1024 * 1024
_VMEM_FIT = 12 * 1024 * 1024


def _vmem_array_bytes(dims, itemsize):
    """TPU VMEM bytes of an array blocked at ``dims``: the last dim padded
    to 128 lanes, the one before to the sublane granule."""
    *lead, s, l = dims
    sub = 32 // itemsize
    padded = -(-s // sub) * sub * -(-l // 128) * 128
    for d in lead:
        padded *= d
    return padded * itemsize


def _working_set_bytes(nb, hh, ww, cin, cout, itemsize, variant,
                       fused=False, has_pre=False, has_skip=False):
    """VMEM bytes of one whole-image grid step at block-batch ``nb``."""
    halo = 0 if (variant == "valid9" or fused) else 2
    per = (2 * _vmem_array_bytes((nb, hh + halo, ww + halo, cin), itemsize)
           + 2 * _vmem_array_bytes((nb, hh, ww, cout), itemsize)
           + _vmem_array_bytes((nb, hh, ww, cout), 4))
    if fused and has_pre:
        per += _vmem_array_bytes((nb, hh, ww, cin), 4)
    if fused and has_skip:
        per += 2 * _vmem_array_bytes((nb, hh, ww, cout), itemsize)
    return per + _vmem_array_bytes((9, cin, cout), itemsize)


def _tiled_working_set(th, ww, cin, cout, itemsize):
    return ((th + 2) * ww * cin * itemsize + 2 * th * ww * cout * itemsize
            + th * ww * cout * 4 + 9 * cin * cout * itemsize)


def _tiledew_working_set(th, ww, cin, cout, itemsize):
    return (2 * (th + 2) * ww * cin * itemsize
            + 2 * th * ww * cout * itemsize + th * ww * cout * 4
            + 9 * cin * cout * itemsize)


def _pick_tile_rows(hh, ww, cin, cout, itemsize, variant="tiled"):
    """Largest H-tile (a divisor of H, at least 2 tiles) whose tiled working
    set fits the budget; None if even a 1-row tile does not."""
    ws = _tiledew_working_set if variant == "tiledew" else _tiled_working_set
    best = None
    for th in range(1, hh // 2 + 1):
        if hh % th == 0 and ws(th, ww, cin, cout, itemsize) <= _VMEM_BUDGET:
            best = th
    return best


def pallas_conv_fits(shape, cout, itemsize, variant="valid9", *,
                     fused=False, has_pre=False, has_skip=False) -> bool:
    """True when the JAX package's conv ``variant`` takes ``shape -> cout``
    (one image's working set within the TPU's VMEM cap)."""
    _, hh, ww, cin = shape
    if variant in ("tiled", "tiledew"):
        return _pick_tile_rows(hh, ww, cin, cout, itemsize,
                               variant) is not None
    return _working_set_bytes(1, hh, ww, cin, cout, itemsize, variant,
                              fused=fused, has_pre=has_pre,
                              has_skip=has_skip) <= _VMEM_FIT


def fused_resblock_ok(x, out_ch: int, *, shape=None) -> bool:
    """The JAX gate of the fused-resblock form: ``NATDIFF_PALLAS_CONV=2``
    (:func:`fused_resblock_enabled`), both channel counts multiples of 128
    and the worst-case fused working set within the cap.  ``shape``
    overrides x's shape (the resampling blocks' convs see the resampled
    map)."""
    shape = tuple(shape or x.shape)
    cin = shape[-1]
    if not fused_resblock_enabled() or cin % 128 or out_ch % 128:
        return False
    worst = (shape[0], shape[1], shape[2], max(cin, out_ch))
    return pallas_conv_fits(worst, out_ch, x.dtype.itemsize, "valid9",
                            fused=True, has_pre=True, has_skip=True)


def large_map(x, cout: int) -> bool:
    """True where the JAX package's unfused ``PConv3x3`` leaves its
    whole-image kernel (:func:`default_variant` does not fit) for the
    halo-tiled one: channel counts multiples of 128 and a large map.  The
    port then runs :func:`conv3x3_tiled` (also where JAX's tiled variant
    would not fit either and JAX falls back to XLA), else :func:`conv3x3`."""
    cin = x.shape[-1]
    return (cin % 128 == 0 and cout % 128 == 0
            and not pallas_conv_fits(tuple(x.shape), cout, x.dtype.itemsize,
                                     default_variant()))
