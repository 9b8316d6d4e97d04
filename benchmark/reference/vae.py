"""The SD VAE's decoder (diffusers ``AutoencoderKL``), plain float32, NHWC.

Written from diffusers' ``Decoder`` as configured by stabilityai/stable-
diffusion-3-medium's ``vae``: 16 latent channels, block widths 128, 256,
512, 512, two resnets a down block and three an up block, GroupNorm(32,
eps 1e-6) with SiLU, one single-head attention in the middle, nearest 2x
upsampling followed by a 3x3 conv, latents unscaled as ``z / 1.5305 +
0.0609``.  The encoder's parameters are declared (never run) so that the
seeded fill gives the decoder the same values as the port's whole VAE.
Departures: ``post_quant_conv``, which SD3's VAE does not have, is kept as
in the port (random 1x1 conv, the same on both sides); the layout is NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .mmdit import Dense, _params
from .precision import F32, Precision


class GN(nn.Module):
    def __init__(self, c):
        super().__init__()
        _params(self, scale=(c,), bias=(c,))

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), 32, self.scale, self.bias,
                         1e-6)
        return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.k = k
        _params(self, kernel=(k, k, cin, cout), bias=(cout,))

    def forward(self, x, p: Precision):
        return p.conv(x, self.kernel, self.bias, padding=self.k // 2)


class Resnet(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GN(cin), Conv(cin, cout)
        self.norm2, self.conv2 = GN(cout), Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, p):
        h = self.conv1(F.silu(self.norm1(x)), p)
        h = self.conv2(F.silu(self.norm2(h)), p)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x, p)
        return x + h


class Attn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = GN(c)
        for n in ("to_q", "to_k", "to_v", "to_out_0"):
            setattr(self, n, Dense(c, c))

    def forward(self, x, p, rows=4096):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(y, p), self.to_k(y, p), self.to_v(y, p)
        o = torch.empty_like(q)
        for r in range(0, h * w, rows):            # blocks of query rows
            s = p.matmul(q[:, r:r + rows], k.transpose(1, 2)) / math.sqrt(c)
            o[:, r:r + rows] = p.matmul(torch.softmax(s, -1), v)
        return x + self.to_out_0(o, p).reshape(b, h, w, c)


class _Walk(nn.Module):
    def __init__(self):
        super().__init__()
        self.walk = []

    def _add(self, name, mod):
        setattr(self, name, mod)
        self.walk.append(name)


class Encoder(_Walk):
    """Declared for the parameters' names and shapes only."""

    def __init__(self, cin, latent, ch, mults, layers):
        super().__init__()
        self.conv_in = Conv(cin, ch)
        c = ch
        for i, m in enumerate(mults):
            for j in range(layers):
                self._add(f"down_blocks_{i}_resnets_{j}", Resnet(c, ch * m))
                c = ch * m
            if i != len(mults) - 1:
                self._add(f"down_blocks_{i}_downsamplers_0_conv", Conv(c, c))
        self._add("mid_block_resnets_0", Resnet(c, c))
        self._add("mid_block_attentions_0", Attn(c))
        self._add("mid_block_resnets_1", Resnet(c, c))
        self.conv_norm_out = GN(c)
        self.conv_out = Conv(c, 2 * latent)


class Decoder(_Walk):
    def __init__(self, cout, latent, ch, mults, layers):
        super().__init__()
        mults = list(reversed(mults))
        c = ch * mults[0]
        self.conv_in = Conv(latent, c)
        self._add("mid_block_resnets_0", Resnet(c, c))
        self._add("mid_block_attentions_0", Attn(c))
        self._add("mid_block_resnets_1", Resnet(c, c))
        for i, m in enumerate(mults):
            for j in range(layers + 1):
                self._add(f"up_blocks_{i}_resnets_{j}", Resnet(c, ch * m))
                c = ch * m
            if i != len(mults) - 1:
                self.walk.append("upsample")
                self._add(f"up_blocks_{i}_upsamplers_0_conv", Conv(c, c))
        self.conv_norm_out = GN(c)
        self.conv_out = Conv(c, cout)

    def forward(self, z, p):
        h = self.conv_in(z, p)
        for name in self.walk:
            if name == "upsample":
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            else:
                h = getattr(self, name)(h, p)
        return self.conv_out(F.silu(self.conv_norm_out(h)), p)


class VAE(nn.Module):
    """``decode(latents) -> images [B, 8H, 8W, 3]``."""

    def __init__(self, *, in_channels=3, latent_channels=16,
                 base_channels=128, ch_mult=(1, 2, 4, 4), layers_per_block=2,
                 scaling_factor=1.5305, shift_factor=0.0609, **_):
        super().__init__()
        self.scaling, self.shift = scaling_factor, shift_factor
        args = (latent_channels, base_channels, tuple(ch_mult),
                layers_per_block)
        self.encoder = Encoder(in_channels, *args)
        self.decoder = Decoder(in_channels, *args)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv(latent_channels, latent_channels, 1)

    def decode(self, latents, p: Precision = F32):
        z = latents / self.scaling + self.shift
        return self.decoder(self.post_quant_conv(z, p), p)
