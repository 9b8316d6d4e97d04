"""NCSN++ with DDPM++ BigGAN blocks, plain float32, NHWC.

Written from score_sde ``models/ncsnpp.py`` and ``layerspp.py`` (Song et
al. 2021) for the configuration ``configs/vp/cifar10_ddpmpp_continuous.py``:
BigGAN residual blocks with in-block resampling, no FIR, the positional
time embedding, conditional, centred input, ``skip_rescale``, attention at
the resolutions given, no progressive paths, the eps prediction as output.
Parameters carry the port's names (``layers.m{i}``; ``GroupNorm_0``,
``Conv_0``, ``Dense_0``, ``NIN_0`` ...; kernels ``[in, out]`` and ``[kh,
kw, in, out]``).  Departures from the published description: none in the
function (dropout is the identity at inference); the layout is NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .precision import F32, Precision


def timestep_embedding(t, dim: int, max_positions: int = 10000):
    """score_sde ``get_timestep_embedding``: sin then cos, ``half - 1``
    in the frequency denominator, float32."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(max_positions) / (half - 1)))
    arg = t.float()[:, None] * freq[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def group_norm(x, scale, bias, groups: int, eps: float = 1e-6):
    b, h, w, c = x.shape
    g = x.reshape(b, h * w, groups, c // groups)
    mu = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((g - mu) / torch.sqrt(var + eps)).reshape(b, h, w, c)
    return y * scale + bias


class _P(nn.Module):
    """A module that holds named parameters of given shapes."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape),
                                             requires_grad=False))


class GN(_P):
    def __init__(self, c):
        super().__init__(scale=(c,), bias=(c,))
        self.groups = min(c // 4, 32)

    def forward(self, x):
        return group_norm(x, self.scale, self.bias, self.groups)


def _dense(cin, cout):
    return _P(kernel=(cin, cout), bias=(cout,))


def _conv(cin, cout, k=3):
    return _P(kernel=(k, k, cin, cout), bias=(cout,))


def _nin(c):
    return _P(W=(c, c), b=(c,))


class ResBlock(nn.Module):
    """``ResnetBlockBigGANpp`` (``layerspp.py:209-274``)."""

    def __init__(self, cin, cout, temb, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.GroupNorm_0 = GN(cin)
        self.Conv_0 = _conv(cin, cout)
        self.Dense_0 = _dense(temb, cout)
        self.GroupNorm_1 = GN(cout)
        self.Conv_1 = _conv(cout, cout)
        if cin != cout or up or down:
            self.Conv_2 = _conv(cin, cout, 1)

    def _resample(self, x):
        if self.up:
            return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        if self.down:
            b, h, w, c = x.shape
            return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
        return x

    def forward(self, x, temb, p: Precision):
        h = self._resample(F.silu(self.GroupNorm_0(x)))
        x = self._resample(x)
        h = p.conv(h, self.Conv_0.kernel, self.Conv_0.bias, padding=1)
        h = h + p.linear(F.silu(temb), self.Dense_0.kernel,
                         self.Dense_0.bias)[:, None, None, :]
        h = p.conv(F.silu(self.GroupNorm_1(h)), self.Conv_1.kernel,
                   self.Conv_1.bias, padding=1)
        if hasattr(self, "Conv_2"):
            x = p.conv(x, self.Conv_2.kernel, self.Conv_2.bias)
        return (x + h) / math.sqrt(2.0)


class Attn(nn.Module):
    """``AttnBlockpp`` (``layerspp.py:62-89``): one head over the pixels."""

    def __init__(self, c):
        super().__init__()
        self.GroupNorm_0 = GN(c)
        for i in range(4):
            setattr(self, f"NIN_{i}", _nin(c))

    def forward(self, x, p: Precision):
        b, h, w, c = x.shape
        y = self.GroupNorm_0(x).reshape(b, h * w, c)
        q, k, v = (p.linear(y, getattr(self, f"NIN_{i}").W,
                            getattr(self, f"NIN_{i}").b) for i in range(3))
        a = torch.softmax(p.matmul(q, k.transpose(1, 2)) / math.sqrt(c), -1)
        y = p.linear(p.matmul(a, v), self.NIN_3.W, self.NIN_3.b)
        return (x + y.reshape(b, h, w, c)) / math.sqrt(2.0)


class NCSNpp(nn.Module):
    """``forward(x [B,H,W,C], t [B], p) -> eps [B,H,W,C]`` in float32."""

    def __init__(self, *, image_size=32, num_channels=3, nf=128,
                 ch_mult=(1, 2, 2, 2), num_res_blocks=4,
                 attn_resolutions=(16,)):
        super().__init__()
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        temb = 4 * nf
        mods = [_dense(nf, temb), _dense(temb, temb),
                _conv(num_channels, nf)]
        hs, cin, res = [nf], nf, image_size
        for lvl, mult in enumerate(ch_mult):
            for _ in range(num_res_blocks):
                mods.append(ResBlock(cin, nf * mult, temb))
                cin = nf * mult
                if res in attn_resolutions:
                    mods.append(Attn(cin))
                hs.append(cin)
            if lvl != len(ch_mult) - 1:
                mods.append(ResBlock(cin, cin, temb, down=True))
                res //= 2
                hs.append(cin)
        mods += [ResBlock(cin, cin, temb), Attn(cin),
                 ResBlock(cin, cin, temb)]
        for lvl in reversed(range(len(ch_mult))):
            for _ in range(num_res_blocks + 1):
                mods.append(ResBlock(cin + hs.pop(), nf * ch_mult[lvl], temb))
                cin = nf * ch_mult[lvl]
            if res in attn_resolutions:
                mods.append(Attn(cin))
            if lvl != 0:
                mods.append(ResBlock(cin, cin, temb, up=True))
                res *= 2
        mods += [GN(cin), _conv(cin, num_channels)]
        self.layers = nn.ModuleDict({f"m{i}": m for i, m in enumerate(mods)})

    def forward(self, x, t, p: Precision = F32):
        it = iter(self.layers.values())
        d0, d1, stem = next(it), next(it), next(it)
        temb = p.linear(timestep_embedding(t, self.nf), d0.kernel, d0.bias)
        temb = p.linear(F.silu(temb), d1.kernel, d1.bias)
        hs = [p.conv(x, stem.kernel, stem.bias, padding=1)]
        nlev = len(self.ch_mult)
        for lvl in range(nlev):
            for _ in range(self.num_res_blocks):
                h = next(it)(hs[-1], temb, p)
                if h.shape[1] in self.attn_resolutions:
                    h = next(it)(h, p)
                hs.append(h)
            if lvl != nlev - 1:
                hs.append(next(it)(hs[-1], temb, p))
        h = next(it)(hs[-1], temb, p)
        h = next(it)(h, p)
        h = next(it)(h, temb, p)
        for lvl in reversed(range(nlev)):
            for _ in range(self.num_res_blocks + 1):
                h = next(it)(torch.cat([h, hs.pop()], dim=-1), temb, p)
            if h.shape[1] in self.attn_resolutions:
                h = next(it)(h, p)
            if lvl != 0:
                h = next(it)(h, temb, p)
        gn, head = next(it), next(it)
        return p.conv(F.silu(gn(h)), head.kernel, head.bias, padding=1)
