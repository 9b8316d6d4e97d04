"""NCSN++ / DDPM++ UNet in PyTorch, NHWC (port of ``naturaldiffusion_tpu/
models/ncsnpp.py``, itself a rebuild of ``deps/score_sde_pytorch/models/
ncsnpp.py:34-381``).

The reference stores every layer in one flat module list and walks it with a
running index; the JAX package names the walk's modules ``m{i}``, and so does
this port (an ``nn.ModuleDict`` keyed ``m{i}``), so the JAX weights map onto
it by name (:func:`.convert.load_jax_params`).

Ported so far: what ``CIFAR10_DDPMPP_CONTINUOUS`` uses — BigGAN resblocks, no
FIR, no progressive paths, positional embedding, conditional, no
scale_by_sigma.  Other options raise ``NotImplementedError``.  The JAX
config's fields that this walk never reads (``dropout``,
``resamp_with_conv``, ``fir_kernel``, ``progressive_combine``,
``fourier_scale``) are left out; each comes back with the slice that reads
it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import layers as L


@dataclasses.dataclass(frozen=True)
class NCSNppConfig:
    image_size: int = 32
    num_channels: int = 3
    nf: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 4
    attn_resolutions: Sequence[int] = (16,)
    conditional: bool = True
    fir: bool = False
    skip_rescale: bool = True
    resblock_type: str = "biggan"            # "ddpm" | "biggan"
    progressive: str = "none"                # "none"|"output_skip"|"residual"
    progressive_input: str = "none"          # "none"|"input_skip"|"residual"
    embedding_type: str = "positional"       # "positional"|"fourier"
    init_scale: float = 0.0
    centered: bool = True
    scale_by_sigma: bool = False


# the config that produced checkpoint_8.pth
# (deps/score_sde_pytorch/configs/vp/cifar10_ddpmpp_continuous.py:22-66)
CIFAR10_DDPMPP_CONTINUOUS = NCSNppConfig()


def _check_supported(cfg: NCSNppConfig) -> None:
    unported = [
        ("resblock_type", cfg.resblock_type != "biggan",
         "ResnetBlockDDPMpp"),
        ("fir", cfg.fir, "FIR resampling"),
        ("progressive", cfg.progressive != "none", "progressive output"),
        ("progressive_input", cfg.progressive_input != "none",
         "progressive input"),
        ("embedding_type", cfg.embedding_type != "positional",
         "the Fourier embedding"),
        ("scale_by_sigma", cfg.scale_by_sigma, "scale_by_sigma"),
    ]
    for field, bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} ({field}={getattr(cfg, field)!r}) "
                                      f"{L._LATER}")


class NCSNpp(nn.Module):
    """``forward(x [B,H,W,C], time_cond [B]) -> [B,H,W,C]``.

    Weights are random from ``seed`` (the JAX package's init: variance
    scaling, zero biases); :func:`.convert.load_jax_params` replaces them.
    The module lands on ``device`` (default ``"cuda"``, which raises
    without a card)."""

    def __init__(self, config: NCSNppConfig = CIFAR10_DDPMPP_CONTINUOUS, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        _check_supported(cfg)
        self.config = cfg
        nf = cfg.nf
        temb_dim = 4 * nf if cfg.conditional else None
        mods: list[nn.Module] = []

        def res(in_ch, out_ch=None, **kw):
            mods.append(L.ResnetBlockBigGANpp(
                in_ch, out_ch, temb_dim=temb_dim, fir=cfg.fir,
                skip_rescale=cfg.skip_rescale, init_scale=cfg.init_scale,
                **kw))

        def attn(ch):
            mods.append(L.AttnBlockpp(ch, skip_rescale=cfg.skip_rescale,
                                      init_scale=cfg.init_scale))

        # the same walk as forward(), recording channel counts
        if cfg.conditional:
            mods += [L.Dense(nf, 4 * nf), L.Dense(4 * nf, 4 * nf)]
        mods.append(L.PConv3x3(cfg.num_channels, nf))
        hs_ch, in_ch, res_now = [nf], nf, cfg.image_size
        for i_level, mult in enumerate(cfg.ch_mult):
            for _ in range(cfg.num_res_blocks):
                res(in_ch, nf * mult)
                in_ch = nf * mult
                if res_now in cfg.attn_resolutions:
                    attn(in_ch)
                hs_ch.append(in_ch)
            if i_level != len(cfg.ch_mult) - 1:
                res(in_ch, down=True)
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
                res(in_ch, up=True)
                res_now *= 2
        mods.append(L.GroupNorm(in_ch, act="silu"))
        mods.append(L.PConv3x3(in_ch, cfg.num_channels,
                               init_scale=cfg.init_scale))
        self.layers = nn.ModuleDict({f"m{i}": m for i, m in enumerate(mods)})

        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(gen)
        self.to(dev)

    def forward(self, x, time_cond):
        cfg = self.config
        it = iter(self.layers.values())
        temb = None
        if cfg.conditional:
            # keep the caller's activation type: the embedding is f32
            temb = L.get_timestep_embedding(time_cond, cfg.nf).to(x.dtype)
            temb = next(it)(temb)
            temb = next(it)(F.silu(temb))
        if not cfg.centered:
            x = 2 * x - 1.0

        hs = [next(it)(x)]
        for i_level in range(len(cfg.ch_mult)):
            for _ in range(cfg.num_res_blocks):
                h = next(it)(hs[-1], temb)
                if h.shape[1] in cfg.attn_resolutions:
                    h = next(it)(h)
                hs.append(h)
            if i_level != len(cfg.ch_mult) - 1:
                hs.append(next(it)(hs[-1], temb))

        h = next(it)(hs[-1], temb)
        h = next(it)(h)
        h = next(it)(h, temb)

        for i_level in reversed(range(len(cfg.ch_mult))):
            for _ in range(cfg.num_res_blocks + 1):
                h = next(it)(torch.cat([h, hs.pop()], dim=-1), temb)
            if h.shape[1] in cfg.attn_resolutions:
                h = next(it)(h)
            if i_level != 0:
                h = next(it)(h, temb)

        h = next(it)(h)         # GroupNorm + SiLU
        return next(it)(h)      # 3x3 head
