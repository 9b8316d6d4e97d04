"""MMDiT, the SD3 multimodal diffusion transformer, in PyTorch, NHWC (port
of ``naturaldiffusion_tpu/models/mmdit.py``, the stand-in for diffusers'
``SD3Transformer2DModel`` of ``src/SD3NaturalInference.py:175-213``).

Two streams, one joint attention (Esser et al., "Scaling Rectified Flow
Transformers", 2024): the patchified 16-channel latents with a 2-D sin/cos
table, and the projected text tokens (the CLIP + T5 concat); each block
modulates both streams (adaLN-Zero), runs one attention over ``[latent;
context]`` and an MLP per stream; the last block drops the context stream.
The conditioning vector is a sinusoidal timestep embedding plus an MLP of
the pooled text.

Modules and parameters keep the flax names (``pos_embed_proj``,
``time_text_embed.timestep_embedder_linear_1``, ``context_embedder``,
``transformer_blocks_{i}.attn_to_q``, ``norm_out_linear``, ``proj_out``),
so :func:`.convert.load_jax_params` carries a flax tree across as it is
and :func:`mmdit_torch_path_map` maps them to the HF checkpoint's keys.
The joint attention runs kernel K9 on the card (``ops.attention.mha``);
with ``quant="w8"`` every ``QDense`` passing ``qmatmul_ok`` runs kernel K7.
The dense layers, LayerNorm and GELU are those of :mod:`.dit`.

The per-token LayerNorm of the two streams is computed per stream: the
JAX package's ``NATDIFF_MMDIT_FUSED_LN`` (one LayerNorm over the
concatenation, the same values) is not carried over.  ``token_constraint``
is JAX's sharding hook between blocks (see :class:`MMDiT`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import attention as A
from ..ops._autograd import is_dtensor
from ..utils.profiling import span
from .dit import (QUANT_MODES, Dense, PatchEmbed, QDense, _tp_axis,
                  batch_only, layer_norm, local_attention, sharded_forward,
                  modulate, timestep_embedding)


def sd3_cropped_pos_embed(embed_dim: int, gh: int, gw: int,
                          max_size: int, base_size: int) -> np.ndarray:
    """diffusers ``PatchEmbed`` positions for SD3: an MAE sin/cos table over
    ``pos_embed_max_size`` with grid coords scaled by ``base_size /
    max_size``, CENTER-cropped to the ``gh x gw`` grid (float64, ``[gh *
    gw, embed_dim]``).  A fresh ``gh``-table, DiT's convention, gives other
    values."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(max_size, dtype=np.float32) / (max_size / base_size)
    grid = np.stack(np.meshgrid(coords, coords), axis=0)      # w first
    emb = np.concatenate([_1d(embed_dim // 2, grid[0]),
                          _1d(embed_dim // 2, grid[1])], axis=1)
    emb = emb.reshape(max_size, max_size, embed_dim)
    top = (max_size - gh) // 2
    left = (max_size - gw) // 2
    return emb[top:top + gh, left:left + gw].reshape(gh * gw, embed_dim)


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128            # latent H=W (128 -> 1024px images)
    patch_size: int = 2
    in_channels: int = 16
    hidden_size: int = 1536           # SD3-medium: 24 * 64
    depth: int = 24
    num_heads: int = 24
    caption_projection_dim: int = 1536
    joint_attention_dim: int = 4096   # T5/CLIP concat token dim
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: bool = False             # SD3.5 uses RMSNorm on q/k


SD3_MEDIUM = MMDiTConfig()


def rms_norm(x, scale, eps: float = 1e-6):
    """flax ``nn.RMSNorm``: ``x * rsqrt(mean(x^2) + eps) * scale`` with the
    statistics in float32, output in the promoted type of x and scale."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * (torch.rsqrt(var + eps) * scale.to(torch.float32))
    return y.to(torch.promote_types(x.dtype, scale.dtype))


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=1e-6)``: one ``scale [dim]``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


def ln_pair(a, b):
    """The per-token LayerNorm of both streams.  JAX computes it as one
    LayerNorm over ``[a; b]`` concatenated along the tokens (its
    ``NATDIFF_MMDIT_FUSED_LN``); per token that is the same function, so
    the port normalizes each stream alone and copies nothing."""
    return layer_norm(a), layer_norm(b)


class TimestepTextEmbed(nn.Module):
    """``c = MLP(sinusoidal(t)) + MLP(pooled)`` (HF ``time_text_embed``);
    the timestep MLP runs in the promoted type of its float32 input and
    the weights, as flax does."""

    def __init__(self, hidden: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder_linear_1 = Dense(256, hidden)
        self.timestep_embedder_linear_2 = Dense(hidden, hidden)
        self.text_embedder_linear_1 = Dense(pooled_dim, hidden)
        self.text_embedder_linear_2 = Dense(hidden, hidden)

    def forward(self, t, pooled):
        temb = self.timestep_embedder_linear_1(timestep_embedding(t, 256))
        temb = self.timestep_embedder_linear_2(F.silu(temb))
        p = self.text_embedder_linear_2(F.silu(
            self.text_embedder_linear_1(pooled)))
        return temb + p


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class JointBlock(nn.Module):
    """One MMDiT block.  ``context_pre_only`` (the last block): the context
    stream gets 2 modulation vectors, in ``AdaLayerNormContinuous``'s
    ``(scale, shift)`` order, feeds the attention only, and the block
    returns ``ctx = None``; its context output layers do not exist."""

    def __init__(self, dim: int, num_heads: int, context_pre_only: bool,
                 qk_norm: bool):
        super().__init__()
        self.num_heads = num_heads
        self.context_pre_only = context_pre_only
        self.qk_norm = qk_norm
        n_ctx_mod = 2 if context_pre_only else 6
        self.norm1_linear = Dense(dim, 6 * dim)
        self.norm1_context_linear = Dense(dim, n_ctx_mod * dim)
        for name in ("attn_to_q", "attn_to_k", "attn_to_v",
                     "attn_add_q_proj", "attn_add_k_proj", "attn_add_v_proj"):
            self.add_module(name, QDense(dim, dim))
        if qk_norm:
            hd = dim // num_heads
            for name in ("attn_norm_q", "attn_norm_k", "attn_norm_added_q",
                         "attn_norm_added_k"):
                self.add_module(name, RMSNorm(hd))
        self.attn_to_out_0 = QDense(dim, dim)
        self.ff_net_0_proj = QDense(dim, 4 * dim)
        self.ff_net_2 = QDense(4 * dim, dim)
        if not context_pre_only:
            self.attn_to_add_out = Dense(dim, dim)
            self.ff_context_net_0_proj = QDense(dim, 4 * dim)
            self.ff_context_net_2 = Dense(4 * dim, dim)

    def _heads(self, v, proj, norm):
        """``[B, T, D] -> [B, T, H, hd]`` after ``proj`` (and the RMSNorm
        ``norm`` under ``qk_norm``, cast back to the activations' type, or
        its float32 scale would promote the attention to float32)."""
        b, t, d = v.shape
        y = batch_only(getattr(self, proj)(v)).reshape(b, t, self.num_heads,
                                                       -1)
        if self.qk_norm and norm is not None:
            y = getattr(self, norm)(y).to(y.dtype)
        return y

    def forward(self, x, ctx, c, mods=None):
        if mods is not None:
            mod_x, mod_c = mods
        else:
            sc = F.silu(c)
            mod_x = self.norm1_linear(sc)
            mod_c = self.norm1_context_linear(sc)
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(batch_only(mod_x), 6, dim=-1)
        cmods = torch.chunk(batch_only(mod_c), 2 if self.context_pre_only
                            else 6, dim=-1)

        lx, lc = ln_pair(x, ctx)
        x_in = modulate(lx, sh1, sc1)
        if self.context_pre_only:
            # AdaLayerNormContinuous chunks (scale, shift): the reverse of
            # AdaLayerNormZero's (shift, scale, ...)
            c_in = modulate(lc, cmods[1], cmods[0])
        else:
            c_in = modulate(lc, cmods[0], cmods[1])

        # joint attention over [latent; context] (diffusers order): the two
        # streams' heads concatenated along the tokens, read by kernel K9
        # as a strided [B, H, T, hd] view
        t_x = x.shape[1]
        q = torch.cat([self._heads(x_in, "attn_to_q", "attn_norm_q"),
                       self._heads(c_in, "attn_add_q_proj",
                                   "attn_norm_added_q")], dim=1)
        k = torch.cat([self._heads(x_in, "attn_to_k", "attn_norm_k"),
                       self._heads(c_in, "attn_add_k_proj",
                                   "attn_norm_added_k")], dim=1)
        v = torch.cat([self._heads(x_in, "attn_to_v", None),
                       self._heads(c_in, "attn_add_v_proj", None)], dim=1)
        if is_dtensor(q):              # sharded: local rows (and heads)
            o = local_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                _tp_axis(self.attn_to_q.kernel), A.mha)
        else:
            o = A.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2)).transpose(1, 2)
        b, t_all = o.shape[:2]
        o = o.reshape(b, t_all, -1)
        o_x, o_c = o[:, :t_x], o[:, t_x:]

        x = x + g1[:, None, :] * self.attn_to_out_0(o_x)
        if self.context_pre_only:
            xm = modulate(layer_norm(x), sh2, sc2)
            ff = self.ff_net_2(_gelu(self.ff_net_0_proj(xm)))
            return x + g2[:, None, :] * ff, None

        ctx = ctx + cmods[2][:, None, :] * self.attn_to_add_out(o_c)
        lx2, lc2 = ln_pair(x, ctx)
        ff = self.ff_net_2(_gelu(self.ff_net_0_proj(modulate(lx2, sh2, sc2))))
        x = x + g2[:, None, :] * ff
        cm = modulate(lc2, cmods[3], cmods[4])
        cff = self.ff_context_net_2(_gelu(self.ff_context_net_0_proj(cm)))
        return x, ctx + cmods[5][:, None, :] * cff


class MMDiT(nn.Module):
    """``forward(x [B,H,W,C], t [B], context [B,T,joint_dim], pooled [B,P],
    mods=None) -> [B, H, W, C]`` (the velocity).

    Weights are random from ``seed``, laid out as the JAX package's init
    and made on ``device`` (default ``"cuda"``, which raises without a
    card; SD3-medium's 2 B parameters are never made on the host): kernels
    N(0, 1/fan_in), biases 0, RMSNorm scales 1, and every adaLN modulation
    and ``proj_out`` zero (the output is 0 until weights are loaded or
    perturbed).  ``quant``: ``None`` or ``"w8"``, settable later through
    :meth:`set_quant`.  ``token_constraint``: a ``parallel.NamedSharding``
    of the ``[B, T, D]`` latent tokens applied between the joint blocks
    (Megatron SP, JAX ``models/mmdit.py:224,271-273``); with DTensor
    parameters (``parallel.mmdit_tp_sharding``) and input the forward runs
    on DTensors, attention on local rows and heads, as the DiT's."""

    def __init__(self, config: MMDiTConfig = SD3_MEDIUM, *,
                 quant: str | None = None, device="cuda", seed: int = 0,
                 token_constraint=None):
        super().__init__()
        if token_constraint is not None and not hasattr(
                token_constraint, "constrain"):
            raise TypeError(f"token_constraint must be a parallel."
                            f"NamedSharding, got {token_constraint!r}")
        self.token_constraint = token_constraint
        dev = resolve_device(device)
        cfg = self.config = config
        d, p = cfg.hidden_size, cfg.patch_size
        with dev:
            self.pos_embed_proj = PatchEmbed(p, cfg.in_channels, d)
            self.time_text_embed = TimestepTextEmbed(
                d, cfg.pooled_projection_dim)
            self.context_embedder = Dense(cfg.joint_attention_dim, d)
            for i in range(cfg.depth):
                self.add_module(f"transformer_blocks_{i}", JointBlock(
                    d, cfg.num_heads, context_pre_only=(i == cfg.depth - 1),
                    qk_norm=cfg.qk_norm))
            self.norm_out_linear = Dense(d, 2 * d)
            self.proj_out = Dense(d, p * p * cfg.in_channels)
        self._pos = {}
        self._init_weights(seed)
        self.set_quant(quant)

    @property
    def blocks(self):
        return [getattr(self, f"transformer_blocks_{i}")
                for i in range(self.config.depth)]

    @property
    def dtype(self) -> torch.dtype:
        return self.context_embedder.kernel.dtype

    def set_quant(self, quant: str | None) -> "MMDiT":
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                             f"{quant!r}")
        for m in self.modules():
            if isinstance(m, QDense):
                m.quant = quant
        self.quant = quant
        return self

    @torch.no_grad()
    def _init_weights(self, seed: int):
        dev = self.context_embedder.kernel.device
        if dev.type == "meta":          # shapes only: nothing to fill
            return
        gen = torch.Generator(device=dev).manual_seed(seed)
        zero = ("norm1_linear", "norm1_context_linear", "norm_out_linear",
                "proj_out")
        for name, prm in self.named_parameters():
            if name.endswith("scale"):
                prm.fill_(1.0)
            elif name.endswith("bias") or any(z in name for z in zero):
                prm.zero_()
            else:
                prm.normal_(0.0, 1.0 / math.sqrt(math.prod(prm.shape[:-1])),
                            generator=gen)

    def pos_table(self, gh: int, gw: int, dtype, device):
        """:func:`sd3_cropped_pos_embed` for a ``gh x gw`` grid as a tensor,
        kept per (grid, type, device)."""
        key = (gh, gw, dtype, device)
        if key not in self._pos:
            cfg = self.config
            self._pos[key] = torch.as_tensor(sd3_cropped_pos_embed(
                cfg.hidden_size, gh, gw, cfg.pos_embed_max_size,
                cfg.sample_size // cfg.patch_size), dtype=dtype,
                device=device)
        return self._pos[key]

    def forward(self, x, t, context, pooled, mods=None):
        """``mods``: one step's slice of :func:`mmdit_schedule_mods`; when
        given, the timestep/pooled MLPs, every block's adaLN product and the
        context embedder are skipped and ``t``, ``pooled`` and ``context``
        are ignored."""
        with span("mmdit.forward"), sharded_forward(x):
            return self._forward(x, t, context, pooled, mods)

    def _forward(self, x, t, context, pooled, mods):
        cfg = self.config
        b, hh, ww, _ = x.shape
        p, d = cfg.patch_size, cfg.hidden_size
        gh, gw = hh // p, ww // p
        tok = self.pos_embed_proj(x)
        tok = tok + self.pos_table(gh, gw, tok.dtype, tok.device)[None]
        if mods is not None:
            c = None
            ctx = mods["ctx_emb"].to(tok.dtype)
        else:
            # both conditioning inputs cast to the stream type: an f32 `c`
            # (the sinusoidal embedding) or f32 text embeddings would
            # promote every block, and kernel K9, to f32
            c = self.time_text_embed(t, pooled).to(tok.dtype)
            ctx = self.context_embedder(context.to(tok.dtype))
        for i, blk in enumerate(self.blocks):
            if self.token_constraint is not None:
                tok = self.token_constraint.constrain(tok)
            tok, ctx = blk(tok, ctx, c,
                           mods=None if mods is None else mods["blocks"][i])
        mod = mods["out"] if mods is not None else self.norm_out_linear(
            F.silu(c))
        # (scale, shift) order
        scale, shift = torch.chunk(batch_only(mod), 2, dim=-1)
        tok = batch_only(self.proj_out(modulate(layer_norm(tok), shift,
                                                scale)))
        out = tok.reshape(b, gh, gw, p, p, cfg.in_channels)
        return out.transpose(2, 3).reshape(b, gh * p, gw * p, cfg.in_channels)


@torch.no_grad()
def mmdit_schedule_mods(model: MMDiT, t_all, pooled, context, dtype=None):
    """Hoist all schedule-dependent conditioning out of the NI loop.

    With a static schedule every step's conditioning vector, and so every
    block's adaLN modulation, is known before the loop: one ``[S*B, d]``
    product per layer instead of one ``[B, d]`` product per layer and step,
    through the model's own modules.  ``t_all``: ``[S]`` schedule times;
    ``pooled`` ``[B, P]`` and ``context`` ``[B, T, joint_dim]``: the
    (CFG-doubled) conditioning.  Returns ``{"blocks": ((mod_x [S,B,6d],
    mod_c [S,B,{2,6}d]), ...), "out": [S,B,2d], "ctx_emb": [B,T,d]}`` in
    ``dtype`` (default: the weights' type); the leaves with a leading
    ``S`` ride the engine's ``step_inputs``, ``ctx_emb`` is constant."""
    s, b = t_all.shape[0], pooled.shape[0]
    if dtype is None:
        dtype = model.dtype
    tt = t_all.to(torch.float32).repeat_interleave(b)              # [S*B]
    pp = pooled[None].expand(s, *pooled.shape).reshape(s * b, -1)
    sc = F.silu(model.time_text_embed(tt, pp).to(dtype))
    blocks = tuple((blk.norm1_linear(sc).reshape(s, b, -1),
                    blk.norm1_context_linear(sc).reshape(s, b, -1))
                   for blk in model.blocks)
    out = model.norm_out_linear(sc).reshape(s, b, -1)
    # the context embedding in the stream type: real text encoders emit f32
    ctx_emb = model.context_embedder(context.to(dtype))
    return {"blocks": blocks, "out": out, "ctx_emb": ctx_emb}


def mmdit_cfg_fwd_mods(model: MMDiT, *, ctx2, pool2, t_all,
                       cfg_scale: float = 7.0):
    """CFG-fused predictor on the hoisted-conditioning path.

    ``ctx2``/``pool2``: the CFG-doubled conditioning ``[text; null]``.
    Returns ``(fwd, step_inputs)`` for the engine's ``step_inputs=``:
    ``fwd(z, t, aux)`` runs the model on ``[z; z]`` and combines ``null +
    cfg_scale * (text - null)``.  The adaLN modulations carry a leading
    ``[S]``; the context embedding is step-constant and closes over
    ``fwd``.  Shared by ``apps.sd3_ni.make_cfg_fwd_mods`` and
    ``SD3Pipeline``."""
    mods = mmdit_schedule_mods(model, t_all, pool2, ctx2)
    ctx_emb = mods.pop("ctx_emb")

    def fwd(z, t, aux):
        b = z.shape[0]
        # the timestep stays f32 (unused under mods=, kept for the shape)
        t2 = torch.as_tensor(t, dtype=torch.float32,
                             device=z.device).reshape(1).expand(2 * b)
        v2 = model(torch.cat([z, z]), t2, ctx2, pool2,
                   mods=dict(aux, ctx_emb=ctx_emb))
        text_v, null_v = v2[:b], v2[b:]
        return null_v + cfg_scale * (text_v - null_v)

    return fwd, mods


def mmdit_torch_path_map(path: tuple[str, ...]) -> str:
    """Flax (and port) module path -> HF ``SD3Transformer2DModel`` dotted
    key, for :func:`.convert.fill_from_torch` (JAX ``models/mmdit.py:383``).
    """
    parts = []
    for seg in path:
        if seg.startswith("transformer_blocks_"):
            parts.append("transformer_blocks."
                         + seg[len("transformer_blocks_"):])
        elif seg == "pos_embed_proj":
            parts.append("pos_embed.proj")
        elif seg.startswith("timestep_embedder_linear_"):
            parts.append("timestep_embedder.linear_" + seg[-1])
        elif seg.startswith("text_embedder_linear_"):
            parts.append("text_embedder.linear_" + seg[-1])
        elif seg == "norm1_linear":
            parts.append("norm1.linear")
        elif seg == "norm1_context_linear":
            parts.append("norm1_context.linear")
        elif seg == "attn_to_out_0":
            parts.append("attn.to_out.0")
        elif seg == "attn_to_add_out":
            parts.append("attn.to_add_out")
        elif seg.startswith("attn_"):
            # attn.to_q/k/v, attn.add_q_proj..., SD3.5's attn.norm_q...
            parts.append("attn." + seg[len("attn_"):])
        elif seg == "ff_net_0_proj":
            parts.append("ff.net.0.proj")
        elif seg == "ff_net_2":
            parts.append("ff.net.2")
        elif seg == "ff_context_net_0_proj":
            parts.append("ff_context.net.0.proj")
        elif seg == "ff_context_net_2":
            parts.append("ff_context.net.2")
        elif seg == "norm_out_linear":
            parts.append("norm_out.linear")
        else:
            parts.append(seg)
    return ".".join(parts)
