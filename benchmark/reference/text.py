"""SD3's text encoders, plain float32: CLIP-L/14, OpenCLIP bigG and the
T5 v1.1 XXL encoder, and SD3's ``encode_prompt``.

Written from the Hugging Face configurations of stabilityai/stable-
diffusion-3-medium (``text_encoder``, ``text_encoder_2``, ``text_encoder_3``)
and diffusers' ``StableDiffusion3Pipeline.encode_prompt``:

* CLIP: token plus position embeddings, pre-norm causal layers
  (``quick_gelu`` for L, exact ``gelu`` for bigG); the penultimate hidden
  state feeds the MMDiT; the pooled vector is the final LayerNorm's output
  at the highest token id (HF's rule for ``eos_token_id == 2``) through
  the bias-free ``text_projection``.
* T5: RMSNorm, unscaled scores plus one bucketed relative-position bias
  shared by every layer, the gated-GELU feed-forward, no mask.
* ``encode_prompt``: [CLIP-L; CLIP-G] penultimate states along the width,
  zero-padded to the joint width, then T5's tokens; pooled = [L; G].

Parameters carry the port's names.  Departures: none in the function.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mmdit import Dense, _params
from .precision import F32, Precision


class LN(nn.Module):
    def __init__(self, d, eps):
        super().__init__()
        self.eps = eps
        _params(self, scale=(d,), bias=(d,))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.scale + self.bias


class Embed(nn.Module):
    def __init__(self, n, d):
        super().__init__()
        _params(self, embedding=(n, d))

    def forward(self, idx):
        return self.embedding[idx]


def _attend(q, k, v, bias, p: Precision):
    return p.matmul(torch.softmax(p.matmul(q, k.transpose(-1, -2)) + bias,
                                  -1), v)


class CLIPLayer(nn.Module):
    def __init__(self, d, heads, inter, act):
        super().__init__()
        self.heads, self.act = heads, act
        self.layer_norm1 = LN(d, 1e-5)
        for n in ("q", "k", "v", "out"):
            setattr(self, f"self_attn_{n}_proj", Dense(d, d))
        self.layer_norm2 = LN(d, 1e-5)
        self.mlp_fc1 = Dense(d, inter)
        self.mlp_fc2 = Dense(inter, d)

    def forward(self, x, causal, p):
        b, t, d = x.shape
        y = self.layer_norm1(x)

        def heads(n):
            return getattr(self, f"self_attn_{n}_proj")(y, p).reshape(
                b, t, self.heads, -1).transpose(1, 2)
        hd = d // self.heads
        o = _attend(heads("q") * hd ** -0.5, heads("k"), heads("v"), causal, p)
        x = x + self.self_attn_out_proj(o.transpose(1, 2).reshape(b, t, d), p)
        h = self.mlp_fc1(self.layer_norm2(x), p)
        h = (h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu"
             else F.gelu(h))
        return x + self.mlp_fc2(h, p)


class CLIPText(nn.Module):
    """``forward(ids [B, 77]) -> (penultimate [B, 77, D], pooled [B, P])``."""

    def __init__(self, *, vocab_size=49408, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_positions=77,
                 hidden_act="quick_gelu", projection_dim=768, **_):
        super().__init__()
        self.num_layers = num_layers
        self.token_embedding = Embed(vocab_size, hidden_size)
        self.position_embedding = Embed(max_positions, hidden_size)
        for i in range(num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(
                hidden_size, num_heads, intermediate_size, hidden_act))
        self.final_layer_norm = LN(hidden_size, 1e-5)
        self.text_projection = Dense(hidden_size, projection_dim, bias=False)

    def forward(self, ids, p: Precision = F32):
        b, t = ids.shape
        x = self.token_embedding(ids) + self.position_embedding(
            torch.arange(t, device=ids.device))[None]
        causal = torch.triu(torch.full((t, t), float("-inf"),
                                       device=ids.device), diagonal=1)
        for i in range(self.num_layers):
            if i == self.num_layers - 1:
                penult = x
            x = getattr(self, f"layers_{i}")(x, causal, p)
        last = self.final_layer_norm(x)
        pooled = last[torch.arange(b, device=ids.device), ids.argmax(-1)]
        return penult, self.text_projection(pooled, p)


class RMS(nn.Module):
    def __init__(self, d):
        super().__init__()
        _params(self, scale=(d,))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
            * self.scale


def t5_buckets(t, num_buckets=32, max_distance=128) -> np.ndarray:
    """HF ``T5Attention._relative_position_bucket``, bidirectional."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(n, 1) / exact)
                     / math.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return out + np.where(n < exact, n, np.minimum(large, nb - 1))


class T5Block(nn.Module):
    def __init__(self, d, heads, dkv, dff):
        super().__init__()
        self.heads = heads
        self.attention_ln = RMS(d)
        for n in ("q", "k", "v"):
            setattr(self, n, Dense(d, heads * dkv, bias=False))
        self.o = Dense(heads * dkv, d, bias=False)
        self.ffn_ln = RMS(d)
        self.wi_0 = Dense(d, dff, bias=False)
        self.wi_1 = Dense(d, dff, bias=False)
        self.wo = Dense(dff, d, bias=False)

    def forward(self, x, bias, p):
        b, t, _ = x.shape
        y = self.attention_ln(x)

        def heads(m):
            return m(y, p).reshape(b, t, self.heads, -1).transpose(1, 2)
        o = _attend(heads(self.q), heads(self.k), heads(self.v), bias, p)
        x = x + self.o(o.transpose(1, 2).reshape(b, t, -1), p)
        y = self.ffn_ln(x)
        return x + self.wo(F.gelu(self.wi_0(y, p), approximate="tanh")
                           * self.wi_1(y, p), p)


class T5(nn.Module):
    """``forward(ids [B, T]) -> [B, T, d_model]``."""

    def __init__(self, *, vocab_size=32128, d_model=4096, d_kv=64,
                 d_ff=10240, num_layers=24, num_heads=64,
                 relative_attention_num_buckets=32,
                 relative_attention_max_distance=128, **_):
        super().__init__()
        self.num_layers = num_layers
        self.nb, self.maxd = (relative_attention_num_buckets,
                              relative_attention_max_distance)
        self.token_embedding = Embed(vocab_size, d_model)
        self.rel_bias = Embed(relative_attention_num_buckets, num_heads)
        for i in range(num_layers):
            setattr(self, f"blocks_{i}", T5Block(d_model, num_heads, d_kv,
                                                 d_ff))
        self.final_layer_norm = RMS(d_model)

    def forward(self, ids, p: Precision = F32):
        t = ids.shape[1]
        x = self.token_embedding(ids)
        bk = torch.as_tensor(t5_buckets(t, self.nb, self.maxd),
                             device=ids.device)
        bias = self.rel_bias(bk).permute(2, 0, 1)[None]
        for i in range(self.num_layers):
            x = getattr(self, f"blocks_{i}")(x, bias, p)
        return self.final_layer_norm(x)


def encode_prompt(penult_l, pooled_l, penult_g, pooled_g, t5_out,
                  joint_dim=4096):
    """diffusers' SD3 ``encode_prompt`` from the three encoders' outputs."""
    clip = torch.cat([penult_l, penult_g], dim=-1)
    clip = F.pad(clip, (0, joint_dim - clip.shape[-1]))
    return (torch.cat([clip, t5_out], dim=1),
            torch.cat([pooled_l, pooled_g], dim=-1))
