"""Int8 quantization: the port of ``naturaldiffusion_tpu/ops/quant.py``.

* :func:`quantize_weight` — static symmetric per-output-channel weights,
  also DiT's ``NATDIFF_QUANT=w8`` path (``models.dit.QDense``).
* :func:`quant_enabled`, :func:`static_amax` — the switch of the W8A8 conv
  path, read per call like the JAX package's: ``NATDIFF_QUANT`` in
  ``int8``, ``int8_all``, ``int8_static``, ``int8_all_static`` (``w8`` is
  DiT's and no conv mode), the static clip ``NATDIFF_QUANT_AMAX`` (6.0).
* :func:`quantize_act` (dynamic, per sample) and
  :func:`quantize_act_static` (a fixed clip).
* :func:`conv3x3_int8` — the 3x3 SAME conv on int8 operands with int32
  sums; :func:`conv1x1_int8` — the 1x1 conv / NIN as one int8 product.

The arithmetic is the JAX package's, step by step, so the int8 operands
are the same bytes:

* rounding half to even (``torch.round``, ``jnp.round``; on the card
  ``__float2int_rn``), then a clip to +-127;
* static: ``x.f32 * (1/s)``, ``s = amax / 127``: Python computes ``1/s``
  in double and it meets the f32 array rounded to f32 (a weak type), so
  the port multiplies by that same f32 constant, never ``127 / amax``;
* dynamic: ``x.f32 / s_x``, a division, ``s_x = max(amax, 1e-30) / 127``
  in f32 per sample;
* dequant: ``scale = s_x * s_w`` in f32 first, then ``acc_i32 -> f32``,
  ``* scale``, ``+ bias.f32`` and a cast to x's type, two roundings
  (XLA on the CPU contracts some of these multiply-adds into FMAs and not
  others, so the port's outputs may differ from the JAX package's there
  by one f32 rounding; the int8 operands and int32 sums do not differ).

:func:`conv3x3_int8` on a CUDA tensor runs ``csrc/conv3x3_int8.cu``, an
implicit GEMM on ``wgmma`` s8 x s8 -> s32 fed by TMA (the bf16 halo,
quantized by a producer warpgroup, and the int8 weights), with the dequant
in its epilogue and split-K across a cluster on the small maps; the JAX
package's is an XLA s8 conv (``ops/quant.py:153-156``), not Pallas.  Its
plain version (:func:`conv3x3_int8_reference`), the CPU's route and the
card's oracle, quantizes as above and runs the conv on float64 copies of
the int8 operands (exact: every partial sum is an integer below
9 * 512 * 127^2 ~ 7.4e7 < 2^53).  :func:`conv1x1_int8` is
``torch._int_mm`` on the card (a library product, as JAX leaves its
``dot_general`` to XLA) and the same float64 product on the CPU.  Neither
falls back: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from . import _cuda
from ._autograd import inference_only
from .conv3x3 import _MIN_BLOCKS, _spatial_tile

_QMAX = 127.0
MODES = ("int8", "int8_all", "int8_static", "int8_all_static")
# the modes that also quantize the 1x1 shortcuts and the attention NINs
WIDE_MODES = ("int8_all", "int8_all_static")
STATIC_MODES = ("int8_static", "int8_all_static")

# constants of csrc/conv3x3_int8.cu (the entry checks them): input channels
# (bytes) per chunk, output pixels and channels per unit, weight ring
# stages, int8 halo row stride, most blocks a split-K cluster takes, bytes
# of the mbarriers and of the alignment slack
_BK, _BM, _BN, _STAGES, _SA = 128, 128, 128, 4, 144
_MAX_SPLITS, _BAR_BYTES, _ALIGN = 4, 128, 1024
# the H100's SMs: a persistent launch takes one block each
_SMS = 132
SMEM_MAX = 232_448
# natdiff_conv3x3_int8(dyn, x, w, s_w, bias, sx, q_mul, s_static, y, B, H,
# W, Cin, Cout, imgs, th, tw, bk, stages, splits, blocks, smem, stream)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_float] * 2 + [ctypes.c_void_p]
             + [ctypes.c_int] * 13 + [ctypes.c_void_p])


def _div_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal (not the same
    float), so the divisor is a 0-dim tensor on t's device (a fill kernel,
    no host copy, so a CUDA graph can capture it)."""
    return t / torch.full((), _QMAX, dtype=t.dtype, device=t.device)


def quant_enabled() -> str | None:
    """The conv mode of ``NATDIFF_QUANT``, read per call: ``int8`` (W8A8 on
    the 3x3 convs whose channel counts are multiples of 128), ``int8_all``
    (also the 1x1 shortcuts and attention NINs), ``int8_static`` and
    ``int8_all_static`` (the same with the fixed activation clip
    :func:`static_amax`); None otherwise (``w8`` is DiT's)."""
    v = os.environ.get("NATDIFF_QUANT", "")
    return v if v in MODES else None


def static_amax() -> float:
    """Activation clip of the static modes (``NATDIFF_QUANT_AMAX``, 6.0)."""
    return float(os.environ.get("NATDIFF_QUANT_AMAX", "6.0"))


def quantize_weight(w: torch.Tensor, axis: int = -1):
    """Static symmetric per-output-channel quantization.

    ``w``: [..., C_out] kernel.  Returns ``(w_i8, s_w)`` with ``s_w`` f32
    kept broadcastable against ``w`` (the reduced axes of size 1):
    ``s_w = max(max|w|, 1e-30) / 127`` over all axes but ``axis``, and
    ``w_i8 = clip(round(w / s_w), -127, 127)`` with round-half-to-even, as
    ``jnp.round`` does; both in float32."""
    ax = axis % w.dim()
    red = tuple(i for i in range(w.dim()) if i != ax)
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=red, keepdim=True) if red else wf.abs()
    s_w = _div_qmax(amax.clamp_min(1e-30))
    w_i8 = torch.clamp(torch.round(wf / s_w), -_QMAX, _QMAX).to(torch.int8)
    return w_i8, s_w


def quantize_act(x: torch.Tensor, per_sample: bool = True):
    """Dynamic symmetric activation quantization: ``(x_i8, s_x)``, ``s_x``
    f32 ``[B, 1, ...]`` per sample (or one scalar tensor), as
    :func:`dynamic_scales` computes it."""
    s = dynamic_scales(x, per_sample)
    s_x = s.reshape((-1,) + (1,) * (x.dim() - 1)) if per_sample else s[0]
    x_i8 = torch.clamp(torch.round(x.to(torch.float32) / s_x),
                       -_QMAX, _QMAX).to(torch.int8)
    return x_i8, s_x


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


def static_scales(amax: float):
    """``(s, q_mul)`` of the static quantize, each as it meets a float32
    array in the JAX package: ``s = amax / 127`` and ``q_mul = 1 / s``,
    computed in double, then rounded to float32."""
    s = amax / _QMAX
    return _f32(s), _f32(1.0 / s)


def quantize_act_static(x: torch.Tensor, amax: float):
    """Static symmetric activation quantization with the clip ``amax``:
    ``(x_i8, s)``, ``s = amax / 127`` a Python float (double)."""
    s = amax / _QMAX
    x_i8 = torch.clamp(torch.round(x.to(torch.float32)
                                   * static_scales(amax)[1]),
                       -_QMAX, _QMAX).to(torch.int8)
    return x_i8, s


def pack_conv_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout: ``[3,3,Cin,Cout]`` int8 ->
    ``[9, Cout, Cin]`` contiguous (each output channel's inputs
    contiguous: the K-major B operand of ``wgmma`` s8, which the kernel's
    tensor map reads as ``[9 Cout, Cin]``)."""
    cin, cout = w_i8.shape[2], w_i8.shape[3]
    return w_i8.reshape(9, cin, cout).transpose(1, 2).contiguous()


def quantize_conv_weight(w: torch.Tensor):
    """``(w_i8 [3,3,Cin,Cout], s_w [Cout] f32, w_kern [9,Cout,Cin])`` of a
    3x3 kernel already cast to the activations' type."""
    w_i8, s_w = quantize_weight(w)
    return w_i8, s_w.reshape(-1), pack_conv_weight(w_i8)


def _act(x, per_sample, act_amax):
    """Quantized activations and the per-sample f32 scale that enters the
    dequant, ``[B]`` (a static or per-tensor scale repeated)."""
    bsz = x.shape[0]
    if act_amax is not None:
        x_i8, s = quantize_act_static(x, act_amax)
        sx = torch.full((bsz,), static_scales(act_amax)[0],
                        dtype=torch.float32, device=x.device)
        return x_i8, sx
    x_i8, s_x = quantize_act(x, per_sample)
    return x_i8, s_x.reshape(-1).expand(bsz).contiguous()


def _dequant(acc, sx, s_w, bias, dtype):
    """``acc_i32 -> f32``, times ``sx[b] * s_w[co]`` (one f32 product), plus
    the f32 bias, cast to ``dtype``: two roundings, as the kernel's
    epilogue computes them."""
    shape = (-1,) + (1,) * (acc.dim() - 1)
    scale = sx.reshape(shape) * s_w.reshape(-1)
    out = acc.to(torch.float32) * scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(dtype)


def conv3x3_int8_reference(x, w_i8, s_w, bias=None, *, per_sample=True,
                           act_amax=None):
    """Plain version of :func:`conv3x3_int8`: the activations quantized as
    the JAX package does, the conv on float64 copies of the int8 operands
    (exact; cuDNN off, so no transform algorithm runs), int32, dequant.
    ``w_i8`` [3,3,Cin,Cout] int8, ``s_w`` [Cout] f32."""
    x_i8, sx = _act(x, per_sample, act_amax)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x_i8.permute(0, 3, 1, 2).double(),
                       w_i8.permute(3, 2, 0, 1).double(), padding=1)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return _dequant(acc, sx, s_w, bias, x.dtype)


def _int8_plan(bsz, hh, ww, cin, cout):
    """The int8 kernel's launch for ``[bsz, hh, ww, cin] -> cout``.

    A unit is a tile of ``_BM`` output pixels (``_spatial_tile``, as the
    bf16 kernel's) times ``_BN`` output channels: ``grid`` is (pixel tiles,
    channel blocks).  Where the units reach ``_MIN_BLOCKS``, one block an
    SM walks them persistently (``blocks`` = min(units, ``_SMS``),
    ``splits`` 1); else the ``cin / _BK`` channel chunks are split across a
    cluster of ``splits`` blocks (the fewest, at most ``_MAX_SPLITS``,
    dividing the chunks, that reach ``_MIN_BLOCKS``; the most where none
    does), one unit a cluster.  Shared memory: :func:`_int8_smem`.  Pure:
    the CPU tests walk it, and the C entry checks it."""
    if cin % _BK or cout % _BN:
        raise ValueError(f"conv3x3_int8 kernel: channel counts must be "
                         f"multiples of 128, got {cin} -> {cout}")
    imgs, th, tw = _spatial_tile(_BM, hh, ww)
    tiles_h, tiles_w = -(-hh // th), -(-ww // tw)
    grid = (-(-bsz // imgs) * tiles_h * tiles_w, cout // _BN)
    units = grid[0] * grid[1]
    kc = cin // _BK
    splits = 1
    if units < _MIN_BLOCKS:
        for s in range(2, _MAX_SPLITS + 1):
            if kc % s == 0:
                splits = s
                if units * s >= _MIN_BLOCKS:
                    break
    blocks = units * splits if splits > 1 else min(units, _SMS)
    halo = imgs * (th + 2) * (tw + 2)
    smem = _int8_smem(halo)
    if smem > SMEM_MAX or halo > _BM * 9 // 4 or units >= 2 ** 30:
        raise ValueError(f"conv3x3_int8: no tile plan for "
                         f"{(bsz, hh, ww, cin)} -> {cout}")
    return dict(bm=_BM, bn=_BN, imgs=imgs, th=th, tw=tw, tiles_h=tiles_h,
                tiles_w=tiles_w, halo_rows=halo, bk=_BK, stages=_STAGES,
                grid=grid, units=units, chunks=kc, splits=splits,
                blocks=blocks, smem=smem)


def _int8_smem(halo):
    """The int8 kernel's dynamic shared memory: alignment slack, the weight
    ring, the bf16 staging, two int8 halo buffers, the mbarriers."""
    return (_ALIGN + _STAGES * _BN * _BK + halo * _BK * 2
            + 2 * halo * _SA + _BAR_BYTES)


@functools.lru_cache(maxsize=512)
def _plan_ints(bsz, hh, ww, cin, cout):
    p = _int8_plan(bsz, hh, ww, cin, cout)
    return (p["imgs"], p["th"], p["tw"], p["bk"], p["stages"], p["splits"],
            p["blocks"], p["smem"])


def _launch(x, w_kern, s_w, bias, sx, act_amax):
    """Launch the int8 kernel on bf16 ``x`` (raises on anything it does not
    take)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_int8 kernel takes bfloat16 activations, "
                         f"got {x.dtype}")
    bsz, hh, ww, cin = x.shape
    cout = w_kern.shape[1]
    if tuple(w_kern.shape) != (9, cout, cin) or w_kern.dtype != torch.int8:
        raise ValueError(f"conv3x3_int8: packed weight {tuple(w_kern.shape)}"
                         f" {w_kern.dtype} != (9, Cout, {cin}) int8")
    if bias is not None and bias.dtype != torch.bfloat16:
        raise ValueError("conv3x3_int8 kernel: bias must be bfloat16")
    ts = [t for t in (x, w_kern, s_w, bias, sx) if t is not None]
    if any(t.device != x.device for t in ts):
        raise ValueError("conv3x3_int8: tensors on several devices")
    if not all(t.is_contiguous() for t in ts) or any(
            t.data_ptr() % 16 for t in (x, w_kern, s_w, bias)
            if t is not None):
        raise ValueError("conv3x3_int8 kernel takes contiguous tensors, x, "
                         "the packed weight, s_w and the bias 16-byte "
                         "aligned")
    if bsz * hh * ww * max(cin, cout) >= 2 ** 31:
        raise ValueError("conv3x3_int8: tensor too large for the kernel")
    if s_w.dtype != torch.float32 or s_w.numel() != cout:
        raise ValueError("conv3x3_int8: s_w must be float32 [Cout]")
    y = torch.empty((bsz, hh, ww, cout), dtype=x.dtype, device=x.device)
    dyn = act_amax is None
    s_static, q_mul = (1.0, 1.0) if dyn else static_scales(act_amax)
    fn = _cuda.entry("conv3x3_int8", "natdiff_conv3x3_int8", _ARGTYPES)
    with _cuda.on_device(x):
        err = fn(int(dyn), x.data_ptr(), w_kern.data_ptr(), s_w.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 sx.data_ptr() if dyn else None, q_mul, s_static,
                 y.data_ptr(), bsz, hh, ww, cin, cout,
                 *_plan_ints(bsz, hh, ww, cin, cout), _cuda.stream_ptr(x))
    _cuda.check("conv3x3_int8", err, "conv3x3_int8")
    return y


def dynamic_scales(x: torch.Tensor, per_sample: bool = True):
    """The dynamic scales ``s_x = max(amax, 1e-30) / 127`` in f32, ``[B]``
    (one value repeated when not ``per_sample``): the largest magnitude by
    one ``aminmax`` over x's own type (exact: a maximum of bf16 values is
    one of them), no f32 copy of x."""
    flat = x.reshape(x.shape[0] if per_sample else 1, -1)
    lo, hi = torch.aminmax(flat, dim=1)
    amax = torch.maximum(-lo, hi).to(torch.float32)
    s_x = _div_qmax(amax.clamp_min(1e-30))
    return s_x.expand(x.shape[0]).contiguous()


@inference_only("conv3x3_int8 (Q1)")
def conv3x3_int8(x, w, bias=None, *, per_sample: bool = True, w_i8=None,
                 s_w=None, act_amax: float | None = None, w_kern=None):
    """3x3 / stride-1 / SAME conv of NHWC ``x`` on int8 operands with int32
    sums; output in x's type.

    ``w``: [3,3,Cin,Cout] float kernel, quantized per call unless
    ``(w_i8, s_w)`` are given (and ``w_kern``, :func:`pack_conv_weight` of
    ``w_i8``, for the card; made per call when absent).  ``act_amax``: the
    static clip (else per-sample dynamic scales).  A CPU tensor takes
    :func:`conv3x3_int8_reference`; a CUDA tensor the hand-written kernel
    (bf16, channel counts multiples of 128) or raises."""
    if w_i8 is None:
        w_i8, s_w, w_kern = quantize_conv_weight(w)
    s_w = s_w.reshape(-1).to(torch.float32)
    if x.dim() != 4 or tuple(w_i8.shape) != (3, 3, x.shape[3],
                                             w_i8.shape[3]):
        raise ValueError(f"conv3x3_int8: weight {tuple(w_i8.shape)} does not "
                         f"match input {tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv3x3_int8_reference(x, w_i8, s_w, bias,
                                      per_sample=per_sample,
                                      act_amax=act_amax)
    if w_kern is None:
        w_kern = pack_conv_weight(w_i8)
    sx = None if act_amax is not None else dynamic_scales(x, per_sample)
    y = _launch(x, w_kern, s_w, bias, sx, act_amax)
    conv3x3_int8.launches += 1
    return y


conv3x3_int8.launches = 0


def quantize_nin_weight(w: torch.Tensor):
    """``(w_i8 [Cin, Cout], s_w [Cout] f32, w_t [Cout, Cin])`` of a 1x1
    kernel (``[1,1,Cin,Cout]`` or ``[Cin,Cout]``) in the activations'
    type; ``w_t`` is the transposed copy ``torch._int_mm`` reads."""
    w2 = w.reshape(w.shape[-2], w.shape[-1])
    w_i8, s_w = quantize_weight(w2)
    return w_i8, s_w.reshape(-1), w_i8.t().contiguous()


def _int_mm(a: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int32 ``a [M, K] @ w_t.T``: ``torch._int_mm`` on the card (it takes
    M > 16 and K, N multiples of 8: fewer rows are padded with zeros), a
    float64 product on the CPU (exact below 2^53)."""
    if a.device.type == "cpu":
        return (a.double() @ w_t.double().t()).to(torch.int32)
    m, k = a.shape
    if k % 8 or w_t.shape[0] % 8:
        raise ValueError(f"conv1x1_int8: torch._int_mm needs K and N "
                         f"multiples of 8, got {k}, {w_t.shape[0]}")
    if m <= 16:
        return torch._int_mm(F.pad(a, (0, 0, 0, 32 - m)), w_t.t())[:m]
    return torch._int_mm(a.contiguous(), w_t.t())


def conv1x1_int8(x, w, bias=None, *, per_sample: bool = True,
                 act_amax: float | None = None, w_q=None):
    """1x1 conv / NIN of ``x [B, ..., Cin]`` on int8 operands, the same
    scheme as :func:`conv3x3_int8`.  ``w``: ``[..., Cin, Cout]`` float
    kernel, quantized per call unless ``w_q`` (:func:`quantize_nin_weight`
    of it) is given."""
    w_i8, s_w, w_t = w_q if w_q is not None else quantize_nin_weight(w)
    x_i8, sx = _act(x, per_sample, act_amax)
    cin, cout = w_i8.shape
    acc = _int_mm(x_i8.reshape(-1, cin), w_t)
    acc = acc.reshape(*x.shape[:-1], cout)
    return _dequant(acc, sx, s_w, bias, x.dtype)
