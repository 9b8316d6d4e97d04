"""Building blocks of the NCSN++ UNet in PyTorch, NHWC (port of the parts
of ``naturaldiffusion_tpu/models/layers.py`` that the CIFAR-10 DDPM++
configuration reaches).

Parameters keep the JAX package's names and layouts (``kernel`` [in, out] or
[kh, kw, in, out], ``bias``, ``scale``, ``W``, ``b``) and submodules keep
its names (``GroupNorm_0``, ``Conv_0``, ``NIN_1``, ...), so carrying the JAX
weights across is a tree walk (:mod:`.convert`).

Every 3x3 conv goes through a hand-written kernel on the card: the resblock
convs through the fused-resblock kernel (``ops.conv3x3.conv3x3_gn``), the
others through the plain conv kernel (``ops.conv3x3.conv3x3``).  The 1x1
convs, ``Dense``, ``NIN`` and the attention products stay plain PyTorch, as
the JAX package leaves them to XLA.  The resblocks run only the fused form
(``NATDIFF_PALLAS_CONV=2`` in the JAX package), which is the same maths as
the unfused one; dropout is the identity (inference only).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as convops
from ..ops.group_norm import (gn_affine_coeffs, gn_channel_sums,
                               group_norm_reference)

_LATER = "is not ported yet (ROADMAP.md, Queue A, item 6: NCSN++ options)"


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

    def reset_parameters(self, generator):
        variance_scaling_(self.W, self.init_scale, generator)

    def forward(self, x):
        return x @ self.W + self.b


class PConv3x3(nn.Module):
    """3x3 / stride-1 / SAME conv, kernel [3,3,in,out].  With ``pre``,
    ``skip`` or ``emit_stats`` it is the fused resblock conv (kernel K3),
    else the plain conv (kernel K2)."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.init_scale = init_scale

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, self.init_scale, generator)

    def forward(self, x, *, pre=None, skip=None, skip_rescale=False,
                emit_stats=False):
        if pre is not None or skip is not None or emit_stats:
            return convops.conv3x3_gn(x, self.kernel, self.bias, pre=pre,
                                      skip=skip, skip_rescale=skip_rescale,
                                      emit_stats=emit_stats)
        return convops.conv3x3(x, self.kernel, self.bias)


class PConv1x1(nn.Module):
    """1x1 / stride-1 conv, kernel [1,1,in,out], as one matrix product."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator):
        variance_scaling_(self.kernel, 1.0, generator)

    def forward(self, x):
        return x @ self.kernel[0, 0] + self.bias


class GroupNorm(nn.Module):
    """GroupNorm(min(c//4, 32)) with float32 statistics (fast variance).

    ``forward`` is the standalone form (plain PyTorch); :meth:`coeffs` is
    the fused-resblock form: the normalize-affine, with an optional
    per-(sample, channel) ``extra_bias`` folded in, collapsed to float32
    [B, C] scalars for the conv kernel's prologue, from the producer's
    channel ``stats`` when given.  ``act`` is applied by ``forward`` and,
    on the fused form, by the kernel's prologue (always SiLU there)."""

    def __init__(self, channels: int, act: str | None = None,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = min(channels // 4, 32)
        self.eps = eps
        self.act = act
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_reference(x, self.scale, self.bias, self.num_groups,
                                    eps=self.eps, act=self.act)

    def coeffs(self, x, extra_bias=None, stats=None):
        s1, s2 = stats if stats is not None else gn_channel_sums(x)
        return gn_affine_coeffs(s1, s2, x.shape[1] * x.shape[2], self.scale,
                                self.bias, self.num_groups, eps=self.eps,
                                extra_bias=extra_bias)


class AttnBlockpp(nn.Module):
    """Single-head self-attention over the H*W tokens (``layerspp.py:62-89``)."""

    def __init__(self, channels: int, skip_rescale: bool = False,
                 init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(channels)
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
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def avg_pool2x2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with in-block resampling (``layerspp.py:209-274``),
    in the fused-resblock form of the JAX package (``layers.py:457-501``).

    Plain form: GN_0 collapses to coefficients on Conv_0's prologue (with its
    SiLU) and Conv_0 emits GN_1's channel sums.  Resampling form: the
    resample sits between GN_0's SiLU and Conv_0, so GN_0 runs standalone
    and Conv_0 only emits the sums.  Both: the temb projection enters GN_1's
    affine algebraically, GN_1 + SiLU ride Conv_1's prologue, and the
    skip-add (+1/sqrt2) is Conv_1's epilogue."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, up: bool = False,
                 down: bool = False, fir: bool = False,
                 skip_rescale: bool = True, init_scale: float = 0.0):
        super().__init__()
        if fir:
            raise NotImplementedError(f"FIR resampling {_LATER}")
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(in_ch, act="silu")
        self.Conv_0 = PConv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch, act="silu")
        self.Conv_1 = PConv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = PConv1x1(in_ch, out_ch)

    def forward(self, x, temb=None):
        if self.up or self.down:
            h = self.GroupNorm_0(x)
            resample = naive_upsample if self.up else avg_pool2x2
            h, x = resample(h), resample(x)
            h, s1, s2 = self.Conv_0(h, emit_stats=True)
        else:
            w0, b0 = self.GroupNorm_0.coeffs(x)
            h, s1, s2 = self.Conv_0(x, pre=(w0, b0), emit_stats=True)
        xs = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        tb = None
        if temb is not None:
            tb = self.Dense_0(F.silu(temb))
        w1, b1 = self.GroupNorm_1.coeffs(h, extra_bias=tb, stats=(s1, s2))
        return self.Conv_1(h, pre=(w1, b1), skip=xs.to(h.dtype),
                           skip_rescale=self.skip_rescale)
