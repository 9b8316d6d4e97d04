"""MMDiT, SD3's multimodal diffusion transformer, plain float32, NHWC.

Written from Esser et al. 2024 (arXiv 2403.03206) and diffusers'
``SD3Transformer2DModel`` as configured by stabilityai/stable-diffusion-3-
medium: patch-2 embedding of the 16-channel latent plus the 2-D sin/cos
table over ``pos_embed_max_size`` (centre-cropped), the timestep's
sinusoidal embedding (cos first) through an MLP plus an MLP of the pooled
text, the context embedder, ``depth`` joint blocks (adaLN-Zero modulation of
both streams, one attention over [latent; context], an MLP a stream; the
last block keeps only the latent stream and modulates the context as
(scale, shift)), the output norm (scale, shift) and projection.
Parameters carry the port's names (``transformer_blocks_{i}.attn_to_q``,
kernels ``[in, out]``).  Departures: none in the function; the layout is
NHWC.  ``cfg_velocity`` is classifier-free guidance over the batch
``[text; null]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import F32, Precision


def _params(mod: nn.Module, **shapes):
    for name, shape in shapes.items():
        setattr(mod, name, nn.Parameter(torch.empty(shape),
                                        requires_grad=False))


class Dense(nn.Module):
    def __init__(self, fin, fout, bias=True):
        super().__init__()
        _params(self, kernel=(fin, fout), **({"bias": (fout,)} if bias
                                              else {}))

    def forward(self, x, p: Precision):
        return p.linear(x, self.kernel, getattr(self, "bias", None))


def layer_norm(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def timestep_embedding(t, dim=256, max_period=10000):
    half = dim // 2
    freq = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freq[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def cropped_pos_table(dim, gh, gw, max_size, base_size) -> np.ndarray:
    def one(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    c = np.arange(max_size, dtype=np.float32) / (max_size / base_size)
    grid = np.stack(np.meshgrid(c, c), axis=0)
    emb = np.concatenate([one(dim // 2, grid[0]), one(dim // 2, grid[1])],
                         axis=1).reshape(max_size, max_size, dim)
    top, left = (max_size - gh) // 2, (max_size - gw) // 2
    return emb[top:top + gh, left:left + gw].reshape(gh * gw, dim)


def attention(q, k, v, p: Precision, head_chunk=4):
    """softmax(q k^T / sqrt(d)) v over ``[B, H, T, d]``, a few heads at a
    time so that the float32 scores fit."""
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5
    for h in range(0, q.shape[1], head_chunk):
        s = p.matmul(q[:, h:h + head_chunk], k[:, h:h + head_chunk]
                     .transpose(-1, -2)) * scale
        out[:, h:h + head_chunk] = p.matmul(torch.softmax(s, -1),
                                            v[:, h:h + head_chunk])
    return out


class JointBlock(nn.Module):
    def __init__(self, d, heads, last):
        super().__init__()
        self.heads, self.last = heads, last
        self.norm1_linear = Dense(d, 6 * d)
        self.norm1_context_linear = Dense(d, (2 if last else 6) * d)
        for n in ("attn_to_q", "attn_to_k", "attn_to_v", "attn_add_q_proj",
                  "attn_add_k_proj", "attn_add_v_proj", "attn_to_out_0"):
            setattr(self, n, Dense(d, d))
        self.ff_net_0_proj = Dense(d, 4 * d)
        self.ff_net_2 = Dense(4 * d, d)
        if not last:
            self.attn_to_add_out = Dense(d, d)
            self.ff_context_net_0_proj = Dense(d, 4 * d)
            self.ff_context_net_2 = Dense(4 * d, d)

    def _mlp(self, x, a, b, p):
        return b(F.gelu(a(x, p), approximate="tanh"), p)

    def forward(self, x, ctx, c, p: Precision):
        sc = F.silu(c)
        sh1, s1, g1, sh2, s2, g2 = self.norm1_linear(sc, p).chunk(6, -1)
        cm = self.norm1_context_linear(sc, p).chunk(2 if self.last else 6, -1)
        xi = modulate(layer_norm(x), sh1, s1)
        ci = (modulate(layer_norm(ctx), cm[1], cm[0]) if self.last
              else modulate(layer_norm(ctx), cm[0], cm[1]))
        b, tx, d = x.shape

        def heads(a, m):
            return m(a, p).reshape(b, a.shape[1], self.heads, -1) \
                .transpose(1, 2)
        q = torch.cat([heads(xi, self.attn_to_q),
                       heads(ci, self.attn_add_q_proj)], dim=2)
        k = torch.cat([heads(xi, self.attn_to_k),
                       heads(ci, self.attn_add_k_proj)], dim=2)
        v = torch.cat([heads(xi, self.attn_to_v),
                       heads(ci, self.attn_add_v_proj)], dim=2)
        o = attention(q, k, v, p).transpose(1, 2).reshape(b, -1, d)
        x = x + g1[:, None] * self.attn_to_out_0(o[:, :tx], p)
        x = x + g2[:, None] * self._mlp(modulate(layer_norm(x), sh2, s2),
                                        self.ff_net_0_proj, self.ff_net_2, p)
        if self.last:
            return x, None
        ctx = ctx + cm[2][:, None] * self.attn_to_add_out(o[:, tx:], p)
        ctx = ctx + cm[5][:, None] * self._mlp(
            modulate(layer_norm(ctx), cm[3], cm[4]),
            self.ff_context_net_0_proj, self.ff_context_net_2, p)
        return x, ctx


class MMDiT(nn.Module):
    """``forward(x [B,H,W,C], t [B], context [B,T,J], pooled [B,P], p) ->
    velocity [B,H,W,C]``."""

    def __init__(self, *, sample_size=128, patch_size=2, in_channels=16,
                 hidden_size=1536, depth=24, num_heads=24,
                 joint_attention_dim=4096, pooled_projection_dim=2048,
                 pos_embed_max_size=192, **_):
        super().__init__()
        d, pch = hidden_size, patch_size
        self.d, self.patch, self.cin = d, pch, in_channels
        self.max_size, self.base = pos_embed_max_size, sample_size // pch
        self.depth = depth
        self._pos = {}
        self.pos_embed_proj = nn.Module()
        _params(self.pos_embed_proj, kernel=(pch, pch, in_channels, d),
                bias=(d,))
        self.time_text_embed = nn.Module()
        for n, fin in (("timestep_embedder_linear_1", 256),
                       ("timestep_embedder_linear_2", d),
                       ("text_embedder_linear_1", pooled_projection_dim),
                       ("text_embedder_linear_2", d)):
            setattr(self.time_text_embed, n, Dense(fin, d))
        self.context_embedder = Dense(joint_attention_dim, d)
        for i in range(depth):
            setattr(self, f"transformer_blocks_{i}",
                    JointBlock(d, num_heads, i == depth - 1))
        self.norm_out_linear = Dense(d, 2 * d)
        self.proj_out = Dense(d, pch * pch * in_channels)

    def forward(self, x, t, context, pooled, p: Precision = F32):
        b, hh, ww, c = x.shape
        pch, d = self.patch, self.d
        gh, gw = hh // pch, ww // pch
        patches = x.reshape(b, gh, pch, gw, pch, c).transpose(2, 3).reshape(
            b, gh * gw, pch * pch * c)
        pe = self.pos_embed_proj
        tok = p.linear(patches, pe.kernel.reshape(-1, d), pe.bias)
        key = (gh, gw, tok.device)
        if key not in self._pos:
            self._pos[key] = torch.as_tensor(cropped_pos_table(
                d, gh, gw, self.max_size, self.base), dtype=torch.float32,
                device=tok.device)
        tok = tok + self._pos[key][None]
        te = self.time_text_embed
        cvec = te.timestep_embedder_linear_2(F.silu(
            te.timestep_embedder_linear_1(timestep_embedding(t), p)), p)
        cvec = cvec + te.text_embedder_linear_2(F.silu(
            te.text_embedder_linear_1(pooled, p)), p)
        ctx = self.context_embedder(context, p)
        for i in range(self.depth):
            tok, ctx = getattr(self, f"transformer_blocks_{i}")(tok, ctx,
                                                                cvec, p)
        scale, shift = self.norm_out_linear(F.silu(cvec), p).chunk(2, -1)
        tok = self.proj_out(modulate(layer_norm(tok), shift, scale), p)
        out = tok.reshape(b, gh, gw, pch, pch, c).transpose(2, 3)
        return out.reshape(b, hh, ww, c)


def cfg_velocity(model: MMDiT, z, t: float, ctx2, pool2, scale: float,
                 p: Precision = F32):
    """``null + scale (text - null)`` with the model run on ``[z; z]``
    against ``ctx2 = [text; null]``."""
    b = z.shape[0]
    tt = torch.full((2 * b,), t, dtype=torch.float32, device=z.device)
    v = model(torch.cat([z, z]), tt, ctx2, pool2, p)
    return v[b:] + scale * (v[:b] - v[b:])
