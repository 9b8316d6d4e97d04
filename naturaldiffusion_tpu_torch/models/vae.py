"""AutoencoderKL, the SD VAE, in PyTorch, NHWC (port of
``naturaldiffusion_tpu/models/vae.py``).

The reference uses diffusers' ``AutoencoderKL`` for DiT's latent decode
(``src/ValidateNaturalInference.py:331``), SD3's decode
(``src/SD3NaturalInference.py:225-243``) and the degradation study's
feature encoder (``src/AnalyzeWeightedSumDegradation.py:37-63``): resnet
blocks, one mid attention, 2x down/upsampling.  The JAX package computes
it with XLA ops (``nn.Conv``, ``nn.GroupNorm``, einsum attention) and no
Pallas kernel, so the port uses library calls: ``F.conv2d`` on
channels-last views, ``F.group_norm`` (32 groups, eps 1e-6) and
``torch.matmul`` with a softmax in the activations' type.  Modules and
parameters keep the flax names (``encoder.down_blocks_0_resnets_1.conv1``,
``decoder.mid_block_attentions_0.to_q``, ``quant_conv``); the
HF ``vae`` keys come from :func:`vae_torch_path_map`.

Both halves compute in the weights' type: inputs are cast to it (JAX
promotes f32 latents and bf16 weights to f32).

Configs: SD 1.x/2.x/DiT (4 latent channels, scaling 0.18215) and SD3 (16
channels, scaling 1.5305, shift 0.0609).
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .dit import Dense
from .ncsnv2 import Conv


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0


SD_VAE = VAEConfig()                                      # DiT / SD1-2
SD3_VAE = VAEConfig(latent_channels=16, scaling_factor=1.5305,
                    shift_factor=0.0609)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-6)`` on NHWC:
    ``scale`` and ``bias [C]``, one ``F.group_norm`` on the channels-last
    view, in x's type."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        y = F.group_norm(x.permute(0, 3, 1, 2), self.groups,
                         self.scale.to(x.dtype), self.bias.to(x.dtype),
                         self.eps)
        return y.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch, 3)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = Conv(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """One-head self-attention over the ``H*W`` pixels: ``softmax(q k^T /
    sqrt(C)) v`` in x's type.  At SD3's 1024^2 decode the mid block sees
    16,384 tokens at C = 512: its scores take 0.5 GB an image in bf16."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out_0 = Dense(channels, channels)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2))
                             / math.sqrt(c), dim=-1)
        y = self.to_out_0(torch.matmul(attn, v)).reshape(b, h, w, c)
        return x + y


class DownConv(Conv):
    """The encoder's downsampler: pad the bottom and right by one, then a
    VALID 3x3 stride-2 conv (diffusers' asymmetric padding)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=0)

    def forward(self, x):
        w = self.kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xp = F.pad(x, (0, 0, 0, 1, 0, 1))
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, self.bias.to(x.dtype),
                     stride=2)
        return y.permute(0, 2, 3, 1).contiguous()


def _upsample_nearest(x):
    """2x nearest-neighbour resize of NHWC ``x`` (``jax.image.resize(...,
    "nearest")`` at an exact factor 2: output pixel i reads i // 2)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


class _Walk(nn.Module):
    """A module whose blocks run in the order they were added (``walk``,
    their names; ``"upsample"`` marks a 2x resize)."""

    def __init__(self):
        super().__init__()
        self.walk = []

    def _add(self, name, mod):
        self.add_module(name, mod)
        self.walk.append(name)

    def run_walk(self, h):
        for name in self.walk:
            h = _upsample_nearest(h) if name == "upsample" \
                else getattr(self, name)(h)
        return h


class Encoder(_Walk):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        self.conv_in = Conv(cfg.in_channels, ch, 3)
        cin = ch
        for i, mult in enumerate(cfg.ch_mult):
            out_ch = ch * mult
            for j in range(cfg.layers_per_block):
                self._add(f"down_blocks_{i}_resnets_{j}",
                          ResnetBlock(cin, out_ch))
                cin = out_ch
            if i != len(cfg.ch_mult) - 1:
                self._add(f"down_blocks_{i}_downsamplers_0_conv",
                          DownConv(out_ch))
        mid = ch * cfg.ch_mult[-1]
        self._add("mid_block_resnets_0", ResnetBlock(cin, mid))
        self._add("mid_block_attentions_0", AttnBlock(mid))
        self._add("mid_block_resnets_1", ResnetBlock(mid, mid))
        self.conv_norm_out = GroupNorm(mid)
        self.conv_out = Conv(mid, 2 * cfg.latent_channels, 3)

    def forward(self, x):
        h = self.run_walk(self.conv_in(x))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(_Walk):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.base_channels
        mults = list(reversed(cfg.ch_mult))
        mid = ch * mults[0]
        self.conv_in = Conv(cfg.latent_channels, mid, 3)
        self._add("mid_block_resnets_0", ResnetBlock(mid, mid))
        self._add("mid_block_attentions_0", AttnBlock(mid))
        self._add("mid_block_resnets_1", ResnetBlock(mid, mid))
        cin = mid
        for i, mult in enumerate(mults):
            out_ch = ch * mult
            for j in range(cfg.layers_per_block + 1):
                self._add(f"up_blocks_{i}_resnets_{j}",
                          ResnetBlock(cin, out_ch))
                cin = out_ch
            if i != len(mults) - 1:
                self.walk.append("upsample")
                self._add(f"up_blocks_{i}_upsamplers_0_conv",
                          Conv(out_ch, out_ch, 3))
        self.conv_norm_out = GroupNorm(cin)
        self.conv_out = Conv(cin, cfg.in_channels, 3)

    def forward(self, z):
        h = self.run_walk(self.conv_in(z))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """``encode(x [B,H,W,3] in [-1, 1], generator=None)`` -> ``(mean,
    logvar)`` ``[B,H/8,W/8,latent]``, or a sample with ``generator``;
    ``decode(z)`` -> ``[B,H,W,3]``.  SD 1.x/2.x VAEs have the 1x1
    ``quant_conv``/``post_quant_conv``; SD3's checkpoint lacks them, and
    :func:`.convert.fill_from_torch` then loads them as identity with zero
    bias (:func:`vae_torch_path_map`'s ``missing``), which equals the
    upstream SD3 VAE that has none.  JAX's converter raises on such a
    checkpoint instead.

    Weights random from ``seed`` as the JAX init lays them out (kernels
    N(0, 1/fan_in), biases 0, GroupNorm scales 1), made on ``device``
    (default ``"cuda"``, which raises without a card)."""

    def __init__(self, config: VAEConfig = SD_VAE, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with dev:
            self.encoder = Encoder(config)
            self.decoder = Decoder(config)
            self.quant_conv = Conv(2 * config.latent_channels,
                                   2 * config.latent_channels, 1)
            self.post_quant_conv = Conv(config.latent_channels,
                                        config.latent_channels, 1)
        self._init_weights(seed)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.kernel.dtype

    @torch.no_grad()
    def _init_weights(self, seed: int):
        gen = torch.Generator(device=self.quant_conv.kernel.device
                              ).manual_seed(seed)
        for name, prm in self.named_parameters():
            if name.endswith("scale"):
                prm.fill_(1.0)
            elif name.endswith("bias"):
                prm.zero_()
            else:
                prm.normal_(0.0, 1.0 / math.sqrt(math.prod(prm.shape[:-1])),
                            generator=gen)

    def encode(self, x, generator: torch.Generator | None = None):
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = torch.chunk(moments, 2, dim=-1)
        if generator is None:
            return mean, logvar
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        return mean + std * torch.randn(mean.shape, generator=generator,
                                        device=mean.device, dtype=mean.dtype)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def forward(self, x, generator: torch.Generator | None = None):
        z = self.encode(x, generator)
        return self.decode(z[0] if isinstance(z, tuple) else z)

    # latent <-> model-space scaling (reference: z / 0.18215 before decode,
    # src/ValidateNaturalInference.py:368; SD3: z / 1.5305 + 0.0609,
    # src/SD3NaturalInference.py:240-241)
    def scale_latents(self, z):
        return (z - self.config.shift_factor) * self.config.scaling_factor

    def unscale_latents(self, z):
        return z / self.config.scaling_factor + self.config.shift_factor


def vae_torch_path_map(path: tuple[str, ...]) -> str:
    """Flax (and port) module path -> HF ``AutoencoderKL`` dotted key, for
    :func:`.convert.fill_from_torch` (JAX ``models/vae.py:169``)."""
    parts = []
    for seg in path:
        for pref in ("down_blocks_", "up_blocks_", "mid_block_resnets_",
                     "mid_block_attentions_"):
            if seg.startswith(pref):
                # down_blocks_0_resnets_1 -> down_blocks.0.resnets.1 etc.
                seg = seg.replace("_resnets_", ".resnets.") \
                    .replace("_attentions_", ".attentions.") \
                    .replace("_downsamplers_0_conv", ".downsamplers.0.conv") \
                    .replace("_upsamplers_0_conv", ".upsamplers.0.conv")
                seg = seg.replace("down_blocks_", "down_blocks.") \
                    .replace("up_blocks_", "up_blocks.") \
                    .replace("mid_block_", "mid_block.")
                break
        if seg == "to_out_0":
            seg = "to_out.0"
        parts.append(seg)
    return ".".join(parts)


_QUANT_CONVS = ("quant_conv", "post_quant_conv")


def _identity_quant_conv(key: str, state_dict, shape: tuple):
    """``vae_torch_path_map.missing``: the port-layout value of a
    ``quant_conv``/``post_quant_conv`` key when the state dict holds no key
    of that conv at all (SD3's VAE): an identity 1x1 kernel, a zero bias.
    None (so :func:`.convert.fill_from_torch` raises) for any other key,
    or where the conv is present in part."""
    conv, _, leaf = key.rpartition(".")
    if (conv.rpartition(".")[2] not in _QUANT_CONVS
            or any(k.startswith(conv + ".") for k in state_dict)):
        return None
    if leaf == "weight" and len(shape) == 4 and shape[:2] == (1, 1) \
            and shape[2] == shape[3]:
        return np.eye(shape[2], dtype=np.float32).reshape(shape)
    if leaf == "bias" and len(shape) == 1:
        return np.zeros(shape, np.float32)
    return None


vae_torch_path_map.missing = _identity_quant_conv
