"""The original DDPM UNet in PyTorch, NHWC (port of ``naturaldiffusion_tpu/
models/ddpm.py``, itself a rebuild of ``deps/score_sde_pytorch/models/
ddpm.py:40-181``).

The pre-NCSN++ architecture: GroupNorm in a fixed 32 groups, skips added
without rescaling, resampling by a padded stride-2 conv (or a 2x2 mean) and
a nearest x2 resize followed by a 3x3 conv.  The modules sit in one flat
walk named as the JAX package names them: ``m{i}`` for each block, and
``m{i}_Conv_0`` for the resampling convs, which the reference keeps inside
its ``Upsample``/``Downsample`` modules; where ``resamp_with_conv`` is off
the walk skips that number, as JAX and the reference do.  So
:func:`.convert.load_jax_params` carries a flax tree across as it is, and
:func:`.convert.fill_from_torch` with :func:`ddpm_torch_path_map` a
reference state dict.

Routes: every 3x3 stride-1 conv is a ``PConv3x3`` (K2, K4 on the large
maps, the int8 conv or the library conv, by the switch), every GroupNorm
runs on K6; the JAX package has no fused form of this block, so neither
has the port (no K3).  The stride-2 downsampling conv, the 1x1 ``NIN``
shortcuts and the attention products are plain PyTorch, as the JAX
package leaves them to XLA.  Dropout is the identity (inference only), so
the JAX config's ``dropout`` is left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import layers as L

_GROUPS = 32


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    image_size: int = 32
    num_channels: int = 3
    nf: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = (16,)
    resamp_with_conv: bool = True
    conditional: bool = True
    centered: bool = True
    scale_by_sigma: bool = False
    # the geometric sigma table that scale_by_sigma reads when no table is
    # given (reference get_sigmas, models/utils.py:50)
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 1000


class ResnetBlockDDPM(nn.Module):
    """The DDPM residual block (JAX ``ddpm.py:27``): GN_0 + SiLU (K6),
    Conv_0, GN_1 + SiLU over ``h + Dense_0(silu(temb))`` (the projection as
    K6's extra bias), Conv_1 (zero init in JAX), then the shortcut
    (``NIN_0``, or ``Conv_2`` with ``conv_shortcut``) where the channel
    count changes, added without rescaling."""

    def __init__(self, in_ch: int, out_ch: int | None = None,
                 temb_dim: int | None = None, conv_shortcut: bool = False):
        super().__init__()
        out_ch = out_ch or in_ch
        self.GroupNorm_0 = L.GroupNorm(in_ch, act="silu", num_groups=_GROUPS)
        self.Conv_0 = L.PConv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = L.Dense(temb_dim, out_ch)
        self.GroupNorm_1 = L.GroupNorm(out_ch, act="silu",
                                       num_groups=_GROUPS)
        self.Conv_1 = L.PConv3x3(out_ch, out_ch, init_scale=0.0)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = L.PConv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = L.NIN(in_ch, out_ch)

    def forward(self, x, temb=None):
        h = self.Conv_0(self.GroupNorm_0(x))
        tb = None if temb is None else self.Dense_0(F.silu(temb))
        h = self.Conv_1(self.GroupNorm_1(h, extra_bias=tb))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return x + h


class DDPM(nn.Module):
    """``forward(x [B,H,W,C], labels [B]) -> [B,H,W,C]``.

    ``labels`` are the timesteps of the positional embedding; with
    ``scale_by_sigma`` they also index the sigma table, truncated to
    integers as JAX's ``astype(int32)``: ``sigmas`` if given (JAX's
    ``DDPM.sigmas``), else the config's geometric table.  Weights are
    random from ``seed`` (the JAX package's init: variance scaling, zero
    biases); :func:`.convert.load_jax_params` replaces them.  The module
    lands on ``device`` (default ``"cuda"``, which raises without a
    card)."""

    def __init__(self, config: DDPMConfig = DDPMConfig(), *, sigmas=None,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        if sigmas is not None:
            self.register_buffer("sigmas", torch.as_tensor(
                sigmas, dtype=torch.float32), persistent=False)
        else:
            self.sigmas = None
        nf, nc = cfg.nf, cfg.num_channels
        temb_dim = 4 * nf if cfg.conditional else None
        mods: dict[str, nn.Module] = {}
        counter = iter(range(10_000))

        def add(mod, suffix=""):
            mods[f"m{next(counter)}{suffix}"] = mod

        def res(in_ch, out_ch=None):
            add(ResnetBlockDDPM(in_ch, out_ch, temb_dim=temb_dim))

        def attn(ch):
            add(L.AttnBlockpp(ch, num_groups=_GROUPS))

        # the same walk as forward(), recording channel counts
        if cfg.conditional:
            add(L.Dense(nf, 4 * nf))
            add(L.Dense(4 * nf, 4 * nf))
        add(L.PConv3x3(nc, nf))
        hs_ch, in_ch, res_now = [nf], nf, cfg.image_size
        for i_level, mult in enumerate(cfg.ch_mult):
            for _ in range(cfg.num_res_blocks):
                res(in_ch, nf * mult)
                in_ch = nf * mult
                if res_now in cfg.attn_resolutions:
                    attn(in_ch)
                hs_ch.append(in_ch)
            if i_level != len(cfg.ch_mult) - 1:
                if cfg.resamp_with_conv:
                    add(L.Conv3x3Stride2(in_ch, in_ch), "_Conv_0")
                else:
                    next(counter)
                res_now //= 2
                hs_ch.append(in_ch)
        res(in_ch)
        attn(in_ch)
        res(in_ch)
        for i_level in reversed(range(len(cfg.ch_mult))):
            for _ in range(cfg.num_res_blocks + 1):
                out_ch = nf * cfg.ch_mult[i_level]
                res(in_ch + hs_ch.pop(), out_ch)
                in_ch = out_ch
            if res_now in cfg.attn_resolutions:
                attn(in_ch)
            if i_level != 0:
                if cfg.resamp_with_conv:
                    add(L.PConv3x3(in_ch, in_ch), "_Conv_0")
                else:
                    next(counter)
                res_now *= 2
        add(L.GroupNorm(in_ch, act="silu", num_groups=_GROUPS))
        add(L.PConv3x3(in_ch, nc, init_scale=0.0))
        self.layers = nn.ModuleDict(mods)

        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(gen)
        self.to(dev)

    def _used_sigmas(self, labels, dtype):
        idx = labels.long()
        if self.sigmas is not None:
            return self.sigmas.to(dtype)[idx]
        cfg = self.config
        table = torch.exp(torch.linspace(
            math.log(cfg.sigma_max), math.log(cfg.sigma_min),
            cfg.num_scales, dtype=torch.float32, device=labels.device))
        return table[idx].to(dtype)

    def forward(self, x, labels):
        cfg = self.config
        it = iter(self.layers.values())
        nlev = len(cfg.ch_mult)

        if cfg.conditional:
            # keep the caller's activation type: the embedding is f32
            temb = L.get_timestep_embedding(labels, cfg.nf).to(x.dtype)
            temb = next(it)(temb)
            temb = next(it)(F.silu(temb))
        else:
            temb = None

        h = x if cfg.centered else 2 * x - 1.0
        hs = [next(it)(h)]
        for i_level in range(nlev):
            for _ in range(cfg.num_res_blocks):
                h = next(it)(hs[-1], temb)
                if h.shape[1] in cfg.attn_resolutions:
                    h = next(it)(h)
                hs.append(h)
            if i_level != nlev - 1:
                hs.append(next(it)(hs[-1]) if cfg.resamp_with_conv
                          else L.avg_pool2x2(hs[-1]))

        h = next(it)(hs[-1], temb)
        h = next(it)(h)
        h = next(it)(h, temb)

        for i_level in reversed(range(nlev)):
            for _ in range(cfg.num_res_blocks + 1):
                h = next(it)(torch.cat([h, hs.pop()], dim=-1), temb)
            if h.shape[1] in cfg.attn_resolutions:
                h = next(it)(h)
            if i_level != 0:
                h = L.naive_upsample(h)
                if cfg.resamp_with_conv:
                    h = next(it)(h)

        gn, conv = next(it), next(it)
        h = conv(gn(h))                 # GroupNorm + SiLU, 3x3 head
        if cfg.scale_by_sigma:
            h = h / self._used_sigmas(labels, h.dtype).reshape(-1, 1, 1, 1)
        return h


def ddpm_torch_path_map(path: tuple[str, ...]) -> str:
    """A port module path -> the reference's torch key prefix: ``m{i}`` ->
    ``all_modules.{i}``, and ``m{i}_Conv_0`` -> ``all_modules.{i}.Conv_0``
    (the reference's resampling convs live inside its Upsample /
    Downsample modules); as JAX's ``ddpm_torch_path_map``."""
    parts = []
    for seg in path:
        if seg.startswith("m") and seg[1:].split("_")[0].isdigit():
            rest = seg[1:].split("_", 1)
            parts.extend(["all_modules", rest[0]])
            if len(rest) > 1:
                parts.append(rest[1])
        else:
            parts.append(seg)
    return ".".join(parts)
