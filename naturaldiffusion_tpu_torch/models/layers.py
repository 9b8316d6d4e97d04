"""Building blocks of the NCSN++ UNet in PyTorch, NHWC (port of
``naturaldiffusion_tpu/models/layers.py``).

Parameters keep the JAX package's names and layouts (``kernel`` [in, out] or
[kh, kw, in, out], ``bias``, ``scale``, ``W``, ``b``, ``weight``) and
submodules keep its names (``GroupNorm_0``, ``Conv_0``, ``NIN_1``,
``Conv2d_0``, ...), so carrying the JAX weights across is a tree walk
(:mod:`.convert`).

Every 3x3 stride-1 conv (``PConv3x3``) takes the JAX package's order of
routes, read per call from the same environment (``ops.conv3x3``,
``ops.quant``): the fused resblock conv (kernel K3,
``ops.conv3x3.conv3x3_gn``); under a ``NATDIFF_QUANT`` int8 mode with
both channel counts multiples of 128 the int8 conv (``ops.quant.
conv3x3_int8``, a hand-written kernel on the card); under
``NATDIFF_PALLAS_CONV`` ``1`` or ``2`` (the port's default) kernel K4
(``conv3x3_tiled``) on the large maps where JAX leaves its whole-image
kernel for the halo-tiled one, else K2 (``conv3x3``, also the 3-channel
stem and head, which JAX leaves to XLA); under ``0`` the library conv
(``conv3x3_library``, cuDNN), as JAX's ``conv3x3_xla``.  The 1x1 convs and
``NIN`` are plain products, or int8 ones (``conv1x1_int8``) under
``int8_all``/``int8_all_static``.  Each int8 weight is quantized once
per state of its parameter (its storage, type, version and the
activations' type) and kept beside it, rebuilt in place when the
parameter changes, so a CUDA graph captured over it reads the new values
after one eager call.  Every standalone GroupNorm goes through K6
(``ops.group_norm.fused_group_norm``) under every switch: the JAX
package's ``NATDIFF_PALLAS_GN`` is not ported.  Attention products, FIR
resampling and the FIR convs stay plain PyTorch, as the JAX package
leaves them to XLA.  Each resblock (BigGAN and DDPM) takes the form the
JAX package gives it (fused, fused after the resampling, or unfused);
dropout is the identity (inference only).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as convops
from ..ops import group_norm as gnops
from ..ops import quant as qops
from ..ops import upfirdn2d as firops


def int8_weight(mod: nn.Module, param: torch.Tensor, dt: torch.dtype, make):
    """``make(param cast to dt)`` (the quantized weight's tensors), made
    once per state of ``param`` and kept on ``mod``: remade when the
    parameter's storage, type, device, version (an in-place change:
    ``load_jax_params``, ``randomize_``) or the activations' type ``dt``
    changes, into the same tensors where the shapes allow, so a CUDA graph
    that captured them reads the new values."""
    ver = None if param.is_inference() else param._version
    key = (param.data_ptr(), param.dtype, param.device, ver, dt)
    held = mod._q8
    if held is not None and held[0] == key:
        return held[1]
    with torch.no_grad():
        new = make(param.detach().to(dt))
        if held is not None and all(
                (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
                for a, b in zip(held[1], new)):
            for a, b in zip(held[1], new):
                a.copy_(b)
            new = held[1]
    mod._q8 = (key, new)
    return new


def _act_amax(qmode):
    return qops.static_amax() if qmode in qops.STATIC_MODES else None


def variance_scaling_(t: torch.Tensor, scale: float,
                      generator: torch.Generator) -> torch.Tensor:
    """DDPM init, as the JAX package's ``default_init``: variance scaling
    (scale, fan_avg, uniform), with scale 0 meaning 1e-10."""
    scale = 1e-10 if scale == 0 else scale
    shape = t.shape
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_positions: int = 10000):
    """Transformer sinusoidal embedding, float32 (with the reference's
    ``half_dim - 1`` frequency denominator)."""
    half = embedding_dim // 2
    emb = math.log(max_positions) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random Fourier features of log-sigma (JAX ``layers.py:49``): ``W``
    [embedding_size] ~ N(0, scale^2), output ``[sin, cos]`` of
    ``x W 2 pi``, 2 * embedding_size wide."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.W = nn.Parameter(torch.empty(embedding_size))
        self.scale = scale

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.W.normal_(0.0, self.scale, generator=generator)

    def forward(self, x):
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias``, kernel [in, out]."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, 1.0, generator)

    def forward(self, x):
        return x @ self.kernel + self.bias


class NIN(nn.Module):
    """1x1 'network-in-network' over the channel axis: ``x @ W + b``."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_scale = init_scale
        self._q8 = None

    def reset_parameters(self, generator):
        variance_scaling_(self.W, self.init_scale, generator)

    def forward(self, x):
        qmode = qops.quant_enabled()
        if (qmode in qops.WIDE_MODES and self.W.shape[0] % 128 == 0
                and self.W.shape[1] % 128 == 0):
            return qops.conv1x1_int8(
                x, None, self.b, act_amax=_act_amax(qmode),
                w_q=int8_weight(self, self.W, x.dtype,
                                qops.quantize_nin_weight))
        return x @ self.W + self.b


class PConv3x3(nn.Module):
    """3x3 / stride-1 / SAME conv, kernel [3,3,in,out], routed as the JAX
    package's ``PConv3x3`` (``layers.py:100-142``; see the module
    docstring): with ``pre``, ``skip`` or ``emit_stats`` the fused
    resblock conv (K3); else the int8 conv under an int8 mode where both
    channel counts are multiples of 128; else K4 or K2 under
    ``NATDIFF_PALLAS_CONV`` ``1``/``2``; else the library conv."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.init_scale = init_scale
        self._q8 = None

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, self.init_scale, generator)

    def route(self, x) -> str:
        """The implementation an unfused call on ``x`` takes: ``"int8"``,
        ``"K4"``, ``"K2"`` or ``"library"``."""
        cin, cout = x.shape[-1], self.kernel.shape[3]
        if qops.quant_enabled() and cin % 128 == 0 and cout % 128 == 0:
            return "int8"
        if convops.pallas_conv_enabled():
            return "K4" if convops.large_map(x, cout) else "K2"
        return "library"

    def forward(self, x, *, pre=None, skip=None, skip_rescale=False,
                emit_stats=False):
        if pre is not None or skip is not None or emit_stats:
            return convops.conv3x3_gn(x, self.kernel, self.bias, pre=pre,
                                      skip=skip, skip_rescale=skip_rescale,
                                      emit_stats=emit_stats)
        route = self.route(x)
        if route == "int8":
            w_i8, s_w, w_kern = int8_weight(self, self.kernel, x.dtype,
                                            qops.quantize_conv_weight)
            return qops.conv3x3_int8(
                x, None, self.bias.to(x.dtype), w_i8=w_i8, s_w=s_w,
                w_kern=w_kern, act_amax=_act_amax(qops.quant_enabled()))
        if route == "K4":
            return convops.conv3x3_tiled(x, self.kernel, self.bias)
        if route == "K2":
            return convops.conv3x3(x, self.kernel, self.bias)
        return convops.conv3x3_library(x, self.kernel, self.bias)


class PConv1x1(nn.Module):
    """1x1 / stride-1 conv, kernel [1,1,in,out], as one matrix product, or
    an int8 one under ``int8_all``/``int8_all_static`` where both channel
    counts are multiples of 128 (JAX ``layers.py:156-182``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self._q8 = None

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, 1.0, generator)

    def forward(self, x):
        qmode = qops.quant_enabled()
        cin, cout = self.kernel.shape[2:]
        if qmode in qops.WIDE_MODES and cin % 128 == 0 and cout % 128 == 0:
            return qops.conv1x1_int8(
                x, None, self.bias.to(x.dtype), act_amax=_act_amax(qmode),
                w_q=int8_weight(self, self.kernel, x.dtype,
                                qops.quantize_nin_weight))
        return x @ self.kernel[0, 0] + self.bias


class GroupNorm(nn.Module):
    """GroupNorm with float32 statistics (fast variance), in
    ``num_groups`` groups: by default NCSN++'s ``min(c // 4, 32)``; the
    original DDPM passes a fixed 32.

    ``forward`` is the standalone form (kernel K6); :meth:`coeffs` is
    the fused-resblock form: the normalize-affine, with an optional
    per-(sample, channel) ``extra_bias`` folded in, collapsed to float32
    [B, C] scalars for the conv kernel's prologue, from the producer's
    channel ``stats`` when given.  ``act`` is applied by ``forward`` and,
    on the fused form, by the kernel's prologue (always SiLU there)."""

    def __init__(self, channels: int, act: str | None = None,
                 eps: float = 1e-6, num_groups: int | None = None):
        super().__init__()
        self.num_groups = (min(channels // 4, 32) if num_groups is None
                           else num_groups)
        self.eps = eps
        self.act = act
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, extra_bias=None):
        return gnops.fused_group_norm(x, self.scale, self.bias,
                                      self.num_groups, eps=self.eps,
                                      act=self.act, extra_bias=extra_bias)

    def coeffs(self, x, extra_bias=None, stats=None):
        s1, s2 = stats if stats is not None else gnops.gn_channel_sums(x)
        return gnops.gn_affine_coeffs(s1, s2, x.shape[1] * x.shape[2],
                                      self.scale, self.bias, self.num_groups,
                                      eps=self.eps, extra_bias=extra_bias)


class AttnBlockpp(nn.Module):
    """Single-head self-attention over the H*W tokens (``layerspp.py:62-89``);
    with ``skip_rescale=False`` and ``num_groups=32`` the original DDPM's
    ``AttnBlock`` (JAX ``ddpm.py:55``)."""

    def __init__(self, channels: int, skip_rescale: bool = False,
                 init_scale: float = 0.0, num_groups: int | None = None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(channels, num_groups=num_groups)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.GroupNorm_0(x)
        q = self.NIN_0(y).reshape(b, h * w, c)
        k = self.NIN_1(y).reshape(b, h * w, c)
        v = self.NIN_2(y).reshape(b, h * w, c)
        attn = torch.einsum("bqc,bkc->bqk", q, k) / math.sqrt(c)
        attn = torch.softmax(attn, dim=-1)
        y = torch.einsum("bqk,bkc->bqc", attn, v).reshape(b, h, w, c)
        out = x + self.NIN_3(y)
        return out / math.sqrt(2.0) if self.skip_rescale else out


def naive_upsample(x, factor: int = 2):
    """Nearest-neighbour upsample (``jax.image.resize(..., "nearest")`` at
    an integer factor)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def avg_pool2x2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class FIRConv2d(nn.Module):
    """3x3 conv fused with FIR up- or down-sampling (JAX ``layers.py:268``),
    parameters ``weight`` [3,3,in,out] and ``bias``; plain PyTorch, as the
    JAX package's is XLA."""

    def __init__(self, in_ch: int, out_ch: int, up: bool = False,
                 down: bool = False, fir_kernel=(1, 3, 3, 1),
                 use_bias: bool = True):
        super().__init__()
        self.up, self.down = up, down
        self.fir_kernel = tuple(fir_kernel)
        self.weight = nn.Parameter(torch.empty(3, 3, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def reset_parameters(self, generator):
        variance_scaling_(self.weight, 1.0, generator)

    def forward(self, x):
        k = list(self.fir_kernel)
        if self.up:
            y = firops.upsample_conv_2d(x, self.weight, k=k)
        elif self.down:
            y = firops.conv_downsample_2d(x, self.weight, k=k)
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2),
                         self.weight.permute(3, 2, 0, 1).to(x.dtype),
                         padding=1).permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias


class Conv3x3Stride2(nn.Module):
    """The non-FIR ``Downsample`` conv (JAX ``layers.py:336-339``): pad
    (0, 1, 0, 1), then a VALID 3x3 conv with stride 2; plain PyTorch, as
    the JAX package's ``nn.Conv`` is XLA."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, 1.0, generator)

    def forward(self, x):
        y = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        y = F.conv2d(y, self.kernel.permute(3, 2, 0, 1).to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1).contiguous() + self.bias


class Upsample(nn.Module):
    """x2 upsample, nearest or FIR, optionally with a conv (JAX
    ``layers.py:295``)."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel=(1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, up=True,
                                      fir_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = PConv3x3(in_ch, out_ch)

    def forward(self, x):
        if not self.fir:
            y = naive_upsample(x)
            return self.Conv_0(y) if self.with_conv else y
        if self.with_conv:
            return self.Conv2d_0(x)
        return firops.upsample_2d(x, k=list(self.fir_kernel))


class Downsample(nn.Module):
    """x2 downsample, average or FIR, optionally with a conv (JAX
    ``layers.py:319``)."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel=(1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, down=True,
                                      fir_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = Conv3x3Stride2(in_ch, out_ch)

    def forward(self, x):
        if not self.fir:
            return self.Conv_0(x) if self.with_conv else avg_pool2x2(x)
        if self.with_conv:
            return self.Conv2d_0(x)
        return firops.downsample_2d(x, k=list(self.fir_kernel))


class Combine(nn.Module):
    """Progressive-input combiner (JAX ``layers.py:347``): a 1x1 conv of
    ``x`` to ``dim2`` channels, then concatenated with or added to ``y``."""

    def __init__(self, in_ch: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"unknown combine method {method!r}")
        self.method = method
        self.Conv_0 = PConv1x1(in_ch, dim2)

    def forward(self, x, y):
        h = self.Conv_0(x)
        return torch.cat([h, y], dim=-1) if self.method == "cat" else h + y


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with in-block resampling (``layerspp.py:209-274``;
    JAX ``layers.py:440-537``), in the three forms the JAX package routes
    between (:meth:`route`):

    * ``"fused"``: GN_0 collapses to coefficients on Conv_0's prologue (with
      its SiLU) and Conv_0 emits GN_1's channel sums (kernel K3 twice);
    * ``"resample_fused"``: the resample sits between GN_0's SiLU and
      Conv_0, so GN_0 runs standalone (K6) and Conv_0 only emits the sums;
    * ``"unfused"``: GN_0 (K6), resample, Conv_0, GN_1 with the temb
      projection as its extra bias (K6), Conv_1 (each conv routed by
      ``PConv3x3``), then the skip-add.

    In both fused forms the temb projection enters GN_1's affine
    algebraically, GN_1 + SiLU ride Conv_1's prologue, and the skip-add
    (+1/sqrt2) is Conv_1's epilogue.  ``tb``: the block's temb projection
    given from outside (``ncsnpp_schedule_biases``), in place of
    ``Dense_0(silu(temb))``."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, up: bool = False,
                 down: bool = False, fir: bool = False,
                 fir_kernel=(1, 3, 3, 1), skip_rescale: bool = True,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.out_ch = out_ch
        self.up, self.down = up, down
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(in_ch, act="silu")
        self.Conv_0 = PConv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch, act="silu")
        self.Conv_1 = PConv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = PConv1x1(in_ch, out_ch)

    def route(self, x) -> str:
        """The JAX package's gate (``layers.py:457-509``) on x's shape and
        type: ``"resample_fused"``, ``"fused"`` or ``"unfused"``."""
        if self.up or self.down:
            b, hh, ww, c = x.shape
            rshape = ((b, hh * 2, ww * 2, c) if self.up
                      else (b, hh // 2, ww // 2, c))
            if convops.fused_resblock_ok(x, self.out_ch, shape=rshape):
                return "resample_fused"
            return "unfused"
        return "fused" if convops.fused_resblock_ok(x, self.out_ch) \
            else "unfused"

    def _resample(self, x):
        if self.up:
            return (firops.upsample_2d(x, k=list(self.fir_kernel)) if self.fir
                    else naive_upsample(x))
        if self.down:
            return (firops.downsample_2d(x, k=list(self.fir_kernel))
                    if self.fir else avg_pool2x2(x))
        return x

    def forward(self, x, temb=None, tb=None):
        form = self.route(x)
        if tb is None and temb is not None:
            tb = self.Dense_0(F.silu(temb))
        if form == "unfused":
            h = self._resample(self.GroupNorm_0(x))
            x = self._resample(x)
            h = self.GroupNorm_1(self.Conv_0(h), extra_bias=tb)
            h = self.Conv_1(h)
            if hasattr(self, "Conv_2"):
                x = self.Conv_2(x)
            out = x + h
            return out / math.sqrt(2.0) if self.skip_rescale else out
        if form == "resample_fused":
            h = self._resample(self.GroupNorm_0(x))
            x = self._resample(x)
            h, s1, s2 = self.Conv_0(h, emit_stats=True)
        else:
            w0, b0 = self.GroupNorm_0.coeffs(x)
            h, s1, s2 = self.Conv_0(x, pre=(w0, b0), emit_stats=True)
        xs = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        w1, b1 = self.GroupNorm_1.coeffs(h, extra_bias=tb, stats=(s1, s2))
        return self.Conv_1(h, pre=(w1, b1), skip=xs.to(h.dtype),
                           skip_rescale=self.skip_rescale)


class ResnetBlockDDPMpp(nn.Module):
    """DDPM++ residual block (``layerspp.py:162-206``; JAX
    ``layers.py:391-437``) in the two forms the JAX package routes between
    (:meth:`route`):

    * ``"fused"`` (``NATDIFF_PALLAS_CONV=2`` and the JAX gate): GN_0
      collapses to coefficients on Conv_0's prologue, and Conv_0 emits
      GN_1's channel sums (K3); the shortcut (``NIN_0``, or ``Conv_2`` with
      ``conv_shortcut``) where the channel count changes; GN_1 with the
      temb projection on Conv_1's prologue and the skip-add (+1/sqrt2) in
      its epilogue (K3);
    * ``"unfused"``: GN_0 + SiLU (K6), Conv_0, GN_1 + SiLU with the temb
      projection as its extra bias (K6), Conv_1, the shortcut, the add.

    ``tb`` as in :class:`ResnetBlockBigGANpp`."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, conv_shortcut: bool = False,
                 skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch or in_ch
        self.out_ch = out_ch
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(in_ch, act="silu")
        self.Conv_0 = PConv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch, act="silu")
        self.Conv_1 = PConv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = PConv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def route(self, x) -> str:
        """The JAX package's gate (``layers.py:409``): ``"fused"`` or
        ``"unfused"``."""
        return ("fused" if convops.fused_resblock_ok(x, self.out_ch)
                else "unfused")

    def _shortcut(self, x):
        if hasattr(self, "Conv_2"):
            return self.Conv_2(x)
        if hasattr(self, "NIN_0"):
            return self.NIN_0(x)
        return x

    def forward(self, x, temb=None, tb=None):
        if tb is None and temb is not None:
            tb = self.Dense_0(F.silu(temb))
        if self.route(x) == "fused":
            w0, b0 = self.GroupNorm_0.coeffs(x)
            h, s1, s2 = self.Conv_0(x, pre=(w0, b0), emit_stats=True)
            xs = self._shortcut(x)
            w1, b1 = self.GroupNorm_1.coeffs(h, extra_bias=tb, stats=(s1, s2))
            return self.Conv_1(h, pre=(w1, b1), skip=xs.to(h.dtype),
                               skip_rescale=self.skip_rescale)
        h = self.Conv_0(self.GroupNorm_0(x))
        h = self.Conv_1(self.GroupNorm_1(h, extra_bias=tb))
        out = self._shortcut(x) + h
        return out / math.sqrt(2.0) if self.skip_rescale else out
