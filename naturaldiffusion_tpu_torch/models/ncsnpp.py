"""NCSN++ / DDPM++ UNet in PyTorch, NHWC (port of ``naturaldiffusion_tpu/
models/ncsnpp.py``, itself a rebuild of ``deps/score_sde_pytorch/models/
ncsnpp.py:34-381``).

The reference stores every layer in one flat module list and walks it with a
running index; the JAX package names the walk's modules ``m{i}``, and so does
this port (an ``nn.ModuleDict`` keyed ``m{i}``), so the JAX weights map onto
it by name (:func:`.convert.load_jax_params`).

Ported: BigGAN and DDPM++ resblocks (``resblock_type``), with or without
FIR, the progressive output paths (``output_skip``, ``residual``) and
input paths (``input_skip``, ``residual``) with ``progressive_combine``
sum or cat, the Fourier and the positional embedding, conditional or not,
``scale_by_sigma`` and ``centered``; ``forward(..., mods=)`` with the
hoisted conditioning of :func:`ncsnpp_schedule_biases`.  The JAX config's
``dropout`` (inference only here) and ``num_train_timesteps`` (never read
by the model) are left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import upfirdn2d as firops
from . import layers as L


@dataclasses.dataclass(frozen=True)
class NCSNppConfig:
    image_size: int = 32
    num_channels: int = 3
    nf: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 4
    attn_resolutions: Sequence[int] = (16,)
    resamp_with_conv: bool = True
    conditional: bool = True
    fir: bool = False
    fir_kernel: Sequence[int] = (1, 3, 3, 1)
    skip_rescale: bool = True
    resblock_type: str = "biggan"            # "ddpm" | "biggan"
    progressive: str = "none"                # "none"|"output_skip"|"residual"
    progressive_input: str = "none"          # "none"|"input_skip"|"residual"
    progressive_combine: str = "sum"         # "sum"|"cat"
    embedding_type: str = "positional"       # "positional"|"fourier"
    fourier_scale: float = 16.0
    init_scale: float = 0.0
    centered: bool = True
    scale_by_sigma: bool = False


# the config that produced checkpoint_8.pth
# (deps/score_sde_pytorch/configs/vp/cifar10_ddpmpp_continuous.py:22-66)
CIFAR10_DDPMPP_CONTINUOUS = NCSNppConfig()

# VE CIFAR-10 NCSN++ (JAX ``models/ncsnpp.py:61-64``): FIR + Fourier
CIFAR10_NCSNPP_CONTINUOUS = NCSNppConfig(
    fir=True, resblock_type="biggan", embedding_type="fourier",
    scale_by_sigma=True, conditional=True)


def _check_supported(cfg: NCSNppConfig, sigmas) -> None:
    for field, allowed in (("resblock_type", ("biggan", "ddpm")),
                           ("progressive", ("none", "output_skip",
                                            "residual")),
                           ("progressive_input", ("none", "input_skip",
                                                  "residual")),
                           ("progressive_combine", ("sum", "cat")),
                           ("embedding_type", ("positional", "fourier"))):
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{field}={getattr(cfg, field)!r} is not one of "
                             f"{allowed}")
    if (cfg.scale_by_sigma and cfg.embedding_type == "positional"
            and sigmas is None):
        raise ValueError("scale_by_sigma with the positional embedding needs "
                         "the per-timestep sigma table (sigmas=)")


def _plain_up(x, cfg):
    """Param-free x2 upsample (JAX ``ncsnpp.py:67``)."""
    if cfg.fir:
        return firops.upsample_2d(x, k=list(cfg.fir_kernel))
    return L.naive_upsample(x)


def _plain_down(x, cfg):
    """Param-free x2 downsample (JAX ``ncsnpp.py:75``)."""
    if cfg.fir:
        return firops.downsample_2d(x, k=list(cfg.fir_kernel))
    return L.avg_pool2x2(x)


class NCSNpp(nn.Module):
    """``forward(x [B,H,W,C], time_cond [B]) -> [B,H,W,C]``.

    ``time_cond`` is the noise level sigma for the Fourier embedding and the
    timestep for the positional one; ``sigmas`` is the per-timestep sigma
    table that ``scale_by_sigma`` reads with the positional embedding (JAX's
    ``NCSNpp.sigmas``).  Weights are random from ``seed`` (the JAX package's
    init: variance scaling, zero biases); :func:`.convert.load_jax_params`
    replaces them.  The module lands on ``device`` (default ``"cuda"``,
    which raises without a card)."""

    def __init__(self, config: NCSNppConfig = CIFAR10_DDPMPP_CONTINUOUS, *,
                 sigmas=None, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = config
        _check_supported(cfg, sigmas)
        self.config = cfg
        if sigmas is not None:
            self.register_buffer("sigmas", torch.as_tensor(
                sigmas, dtype=torch.float32), persistent=False)
        else:
            self.sigmas = None
        nf, nc = cfg.nf, cfg.num_channels
        temb_dim = 4 * nf if cfg.conditional else None
        fir = dict(fir=cfg.fir, fir_kernel=tuple(cfg.fir_kernel))
        mods: list[nn.Module] = []

        ddpm = cfg.resblock_type == "ddpm"

        def res(in_ch, out_ch=None, **kw):
            if ddpm:
                mods.append(L.ResnetBlockDDPMpp(
                    in_ch, out_ch, temb_dim=temb_dim,
                    skip_rescale=cfg.skip_rescale,
                    init_scale=cfg.init_scale))
                return
            mods.append(L.ResnetBlockBigGANpp(
                in_ch, out_ch, temb_dim=temb_dim,
                skip_rescale=cfg.skip_rescale, init_scale=cfg.init_scale,
                **fir, **kw))

        def resample(ch, up):
            # the DDPM++ walk resamples between blocks (JAX ``ncsnpp.py:185,
            # 255``), the BigGAN walk inside a block
            if not ddpm:
                res(ch, up=up, down=not up)
            elif up:
                mods.append(L.Upsample(ch, with_conv=cfg.resamp_with_conv,
                                       **fir))
            else:
                mods.append(L.Downsample(ch, with_conv=cfg.resamp_with_conv,
                                         **fir))

        def attn(ch):
            mods.append(L.AttnBlockpp(ch, skip_rescale=cfg.skip_rescale,
                                      init_scale=cfg.init_scale))

        # the same walk as forward(), recording channel counts
        if cfg.embedding_type == "fourier":
            mods.append(L.GaussianFourierProjection(nf, cfg.fourier_scale))
        if cfg.conditional:
            emb = 2 * nf if cfg.embedding_type == "fourier" else nf
            mods += [L.Dense(emb, 4 * nf), L.Dense(4 * nf, 4 * nf)]
        mods.append(L.PConv3x3(nc, nf))
        hs_ch, in_ch, res_now, pyr_ch = [nf], nf, cfg.image_size, nc
        for i_level, mult in enumerate(cfg.ch_mult):
            for _ in range(cfg.num_res_blocks):
                res(in_ch, nf * mult)
                in_ch = nf * mult
                if res_now in cfg.attn_resolutions:
                    attn(in_ch)
                hs_ch.append(in_ch)
            if i_level != len(cfg.ch_mult) - 1:
                resample(in_ch, up=False)
                res_now //= 2
                if cfg.progressive_input == "input_skip":
                    mods.append(L.Combine(nc, in_ch,
                                          cfg.progressive_combine))
                    if cfg.progressive_combine == "cat":
                        in_ch *= 2
                elif cfg.progressive_input == "residual":
                    mods.append(L.Downsample(pyr_ch, in_ch, with_conv=cfg
                                             .resamp_with_conv, **fir))
                    pyr_ch = in_ch
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
            if cfg.progressive != "none":
                if i_level == len(cfg.ch_mult) - 1:
                    mods.append(L.GroupNorm(in_ch, act="silu"))
                    if cfg.progressive == "output_skip":
                        mods.append(L.PConv3x3(in_ch, nc,
                                               init_scale=cfg.init_scale))
                        pyr_ch = nc
                    else:
                        mods.append(L.PConv3x3(in_ch, in_ch))
                        pyr_ch = in_ch
                elif cfg.progressive == "output_skip":
                    mods.append(L.GroupNorm(in_ch, act="silu"))
                    mods.append(L.PConv3x3(in_ch, nc,
                                           init_scale=cfg.init_scale))
                else:
                    mods.append(L.Upsample(pyr_ch, in_ch, with_conv=cfg
                                           .resamp_with_conv, **fir))
                    pyr_ch = in_ch
            if i_level != 0:
                resample(in_ch, up=True)
                res_now *= 2
        if cfg.progressive != "output_skip":
            mods.append(L.GroupNorm(in_ch, act="silu"))
            mods.append(L.PConv3x3(in_ch, nc, init_scale=cfg.init_scale))
        self.layers = nn.ModuleDict({f"m{i}": m for i, m in enumerate(mods)})

        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(gen)
        self.to(dev)

    def forward(self, x, time_cond, mods=None):
        """``mods``: one step's slice of :func:`ncsnpp_schedule_biases`
        (``{resblock name: [1, C]}``); when given, the embedding chain and
        every resblock's ``Dense_0`` are skipped (``time_cond`` is then read
        only for ``scale_by_sigma``), as the JAX package's ``mods=``."""
        cfg = self.config
        items = iter(self.layers.items())
        it = (m for _, m in items)
        nlev = len(cfg.ch_mult)
        ddpm = cfg.resblock_type == "ddpm"

        def res(h, temb):
            name, m = next(items)
            return m(h, temb, tb=None if mods is None else mods[name])

        def resample(h, temb):
            return next(it)(h) if ddpm else res(h, temb)

        used_sigmas = None
        if mods is not None and not cfg.conditional:
            raise ValueError("mods= requires a conditional model")
        if cfg.embedding_type == "fourier":
            used_sigmas = time_cond
            proj = next(it)
            if mods is None:
                temb = proj(torch.log(used_sigmas))
        else:
            if mods is None:
                temb = L.get_timestep_embedding(time_cond, cfg.nf)
            if self.sigmas is not None:
                used_sigmas = self.sigmas.to(x.dtype)[time_cond.long()]
        if mods is not None:
            next(it), next(it)           # the embedder's two Dense
            temb = None
        elif cfg.conditional:
            # keep the caller's activation type: the embedding is f32
            temb = next(it)(temb.to(x.dtype))
            temb = next(it)(F.silu(temb))
        else:
            temb = None
        if not cfg.centered:
            x = 2 * x - 1.0

        input_pyramid = x if cfg.progressive_input != "none" else None
        hs = [next(it)(x)]
        for i_level in range(nlev):
            for _ in range(cfg.num_res_blocks):
                h = res(hs[-1], temb)
                if h.shape[1] in cfg.attn_resolutions:
                    h = next(it)(h)
                hs.append(h)
            if i_level != nlev - 1:
                h = resample(hs[-1], temb)
                if cfg.progressive_input == "input_skip":
                    input_pyramid = _plain_down(input_pyramid, cfg)
                    h = next(it)(input_pyramid, h)
                elif cfg.progressive_input == "residual":
                    input_pyramid = next(it)(input_pyramid) + h
                    if cfg.skip_rescale:
                        input_pyramid = input_pyramid / math.sqrt(2.0)
                    h = input_pyramid
                hs.append(h)

        h = res(hs[-1], temb)
        h = next(it)(h)
        h = res(h, temb)

        pyramid = None
        for i_level in reversed(range(nlev)):
            for _ in range(cfg.num_res_blocks + 1):
                h = res(torch.cat([h, hs.pop()], dim=-1), temb)
            if h.shape[1] in cfg.attn_resolutions:
                h = next(it)(h)
            if cfg.progressive != "none":
                if i_level == nlev - 1:
                    gn, conv = next(it), next(it)
                    pyramid = conv(gn(h))
                elif cfg.progressive == "output_skip":
                    gn, conv = next(it), next(it)
                    pyramid = _plain_up(pyramid, cfg) + conv(gn(h))
                else:
                    pyramid = next(it)(pyramid) + h
                    if cfg.skip_rescale:
                        pyramid = pyramid / math.sqrt(2.0)
                    h = pyramid
            if i_level != 0:
                h = resample(h, temb)

        if cfg.progressive == "output_skip":
            h = pyramid
        else:
            gn, conv = next(it), next(it)
            h = conv(gn(h))             # GroupNorm + SiLU, 3x3 head
        if cfg.scale_by_sigma:
            h = h / used_sigmas.reshape(-1, 1, 1, 1)
        return h


@torch.no_grad()
def ncsnpp_schedule_biases(model: NCSNpp, t_all, dtype=None):
    """Every resblock's temb projection at each of the schedule's times,
    computed once (JAX ``ncsnpp.py:274-316``): under a static NI schedule
    the timestep is one scalar for the whole batch at each step, so the
    embedding chain and each ``Dense_0`` are loop constants.  Runs the
    model's own modules on ``t_all`` [S] (the schedule's times, e.g.
    ``sched.node[:, 0]``), in ``dtype`` (default: the embedder's weight
    type, as the forward casts to x's type).  Returns ``{resblock name:
    [S, 1, C]}`` for the engine's ``step_inputs=``; step k's ``[1, C]``
    slice broadcasts over the batch through GN_1's extra bias."""
    cfg = model.config
    if not cfg.conditional:
        raise ValueError("schedule-bias hoist requires a conditional model")
    layers = model.layers
    t_all = torch.as_tensor(t_all, dtype=torch.float32,
                            device=next(model.parameters()).device)
    if cfg.embedding_type == "fourier":
        temb = layers["m0"](torch.log(t_all))
        d0 = 1
    else:
        temb = L.get_timestep_embedding(t_all, cfg.nf)
        d0 = 0
    dtype = dtype or layers[f"m{d0}"].kernel.dtype
    temb = layers[f"m{d0}"](temb.to(dtype))
    sa = F.silu(layers[f"m{d0 + 1}"](F.silu(temb)))
    return {name: m.Dense_0(sa)[:, None, :] for name, m in layers.items()
            if hasattr(m, "Dense_0")}
