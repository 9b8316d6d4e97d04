"""SD3's text encoders in PyTorch: CLIP-L, CLIP-G and the T5-XXL encoder
(port of ``naturaldiffusion_tpu/models/text_encoders.py``).

The reference drives the MMDiT through ``pipe.encode_prompt``, three text
encoders (``src/SD3NaturalInference.py:175-184``): ``text_encoder`` =
CLIP-L/14, ``text_encoder_2`` = OpenCLIP bigG, ``text_encoder_3`` = the
T5-v1.1-XXL encoder.  The JAX package computes their attention as plain
einsums, so the port uses ``torch.matmul`` and a softmax in the
activations' type; no kernel of the port is on this path.  Modules and
parameters keep the flax names (``layers_{i}.self_attn_q_proj``,
``blocks_{i}.wi_0``, ``rel_bias``), with :func:`clip_torch_path_map` and
:func:`t5_torch_path_map` to the HF checkpoints' keys.

Upstream quirks kept (each changes the numbers):

* CLIP pooling: for ``eos_token_id == 2`` (both SD3 CLIP configs) HF pools
  at the highest token id (``input_ids.argmax(-1)``), else at the first
  EOS; the pooled vector goes through the bias-free ``text_projection``.
* diffusers feeds the MMDiT the **penultimate** hidden state (the input of
  the last layer), not the final LayerNorm's output.
* CLIP is causal (a ``-inf`` bias above the diagonal); CLIP-L uses
  ``quick_gelu``, bigG exact ``gelu``.
* T5's scores are not scaled by 1/sqrt(d); its relative-position bias is
  computed once and shared by every layer; its FF is gated
  (``wo(gelu_tanh(wi_0 x) * wi_1 x)``); it runs without a mask.

Tokenization lives in :mod:`..text`; these encoders take ``[B, T]`` ids.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .dit import Dense, Embed


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"      # CLIP-L; bigG uses "gelu"
    projection_dim: int = 768
    eos_token_id: int = 2
    layer_norm_eps: float = 1e-5


# SD3-medium text_encoder / text_encoder_2
CLIP_L_SD3 = CLIPTextConfig()
CLIP_G_SD3 = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                            intermediate_size=5120, hidden_act="gelu",
                            projection_dim=1280)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps)``: ``scale`` and ``bias [dim]``,
    float32 statistics with ``var = max(E[x^2] - E[x]^2, 0)``, output in
    the promoted type of x and the parameters."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(torch.float32)
        y = (xf - mean) * mul + self.bias.to(torch.float32)
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


def _softmax_attention(q, k, v, bias):
    """``softmax(q k^T + bias) v`` over ``[B, H, T, hd]``, in the promoted
    type of the operands (the JAX package's einsum pair)."""
    s = torch.matmul(q, k.transpose(-1, -2)) + bias
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


class _CLIPLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        d = c.hidden_size
        self.num_heads = c.num_heads
        self.act = _act(c.hidden_act)
        self.layer_norm1 = LayerNorm(d, c.layer_norm_eps)
        self.self_attn_q_proj = Dense(d, d)
        self.self_attn_k_proj = Dense(d, d)
        self.self_attn_v_proj = Dense(d, d)
        self.self_attn_out_proj = Dense(d, d)
        self.layer_norm2 = LayerNorm(d, c.layer_norm_eps)
        self.mlp_fc1 = Dense(d, c.intermediate_size)
        self.mlp_fc2 = Dense(c.intermediate_size, d)

    def forward(self, x, causal_bias):
        ln = self.layer_norm1(x)
        b, t, d = ln.shape
        hd = d // self.num_heads

        def heads(v):
            return v.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        q = heads(self.self_attn_q_proj(ln)) * (hd ** -0.5)
        k = heads(self.self_attn_k_proj(ln))
        v = heads(self.self_attn_v_proj(ln))
        o = _softmax_attention(q, k, v, causal_bias)
        x = x + self.self_attn_out_proj(o.transpose(1, 2).reshape(b, t, d))
        y = self.mlp_fc2(self.act(self.mlp_fc1(self.layer_norm2(x))))
        return x + y


class CLIPTextEncoder(nn.Module):
    """``forward(ids [B, T]) -> (penultimate_hidden [B, T, D], pooled_proj
    [B, P])``.  Weights random from ``seed`` as the JAX init lays them out
    (kernels and embeddings N(0, 1/fan_in), biases 0, LayerNorm scales 1),
    made on ``device`` (default ``"cuda"``, which raises without a card).
    """

    def __init__(self, config: CLIPTextConfig = CLIP_L_SD3, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        c = self.config = config
        with dev:
            self.token_embedding = Embed(c.vocab_size, c.hidden_size)
            self.position_embedding = Embed(c.max_positions, c.hidden_size)
            for i in range(c.num_layers):
                self.add_module(f"layers_{i}", _CLIPLayer(c))
            self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)
            self.text_projection = Dense(c.hidden_size, c.projection_dim,
                                         bias=False)
        _init_weights(self, seed)

    def forward(self, input_ids):
        c = self.config
        b, t = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding(
            torch.arange(t, device=input_ids.device))[None]
        causal = torch.triu(torch.full((t, t), float("-inf"), dtype=x.dtype,
                                       device=x.device), diagonal=1)
        penult = None
        for i in range(c.num_layers):
            if i == c.num_layers - 1:
                penult = x
            x = getattr(self, f"layers_{i}")(x, causal)
        last = self.final_layer_norm(x)
        if c.eos_token_id == 2:
            # HF's legacy rule (both SD3 CLIP configs): the highest token id
            eos_pos = torch.argmax(input_ids, dim=-1)
        else:
            eos_pos = torch.argmax((input_ids == c.eos_token_id).to(
                torch.int32), dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos_pos]
        return penult, self.text_projection(pooled)


def clip_torch_path_map(path: tuple[str, ...]) -> str:
    """Flax (and port) path -> HF ``CLIPTextModelWithProjection`` dotted key
    prefix (JAX ``models/text_encoders.py:143``)."""
    parts = []
    for seg in path:
        if seg.startswith("layers_"):
            parts.append("text_model.encoder.layers." + seg[len("layers_"):])
        elif seg in ("token_embedding", "position_embedding"):
            parts.append("text_model.embeddings." + seg)
        elif seg == "final_layer_norm":
            parts.append("text_model.final_layer_norm")
        elif seg.startswith("self_attn_"):
            parts.append("self_attn." + seg[len("self_attn_"):])
        elif seg.startswith("mlp_"):
            parts.append("mlp." + seg[len("mlp_"):])
        else:
            parts.append(seg)
    return ".".join(parts)


# ---------------------------------------------------------------------------
# T5 v1.1 encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6


# SD3's text_encoder_3 (google/t5-v1_1-xxl encoder)
T5_XXL = T5Config()


class RMSNorm(nn.Module):
    """T5's norm as the JAX package writes it: ``(x * rsqrt(mean(x^2) +
    eps)).astype(x.dtype) * scale``, the mean of squares in float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        xf = x.to(torch.float32)
        var = (xf * xf).mean(dim=-1, keepdim=True)
        dt = torch.promote_types(x.dtype, self.scale.dtype)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype).to(dt) \
            * self.scale.to(dt)


def t5_relative_buckets(t: int, num_buckets: int = 32,
                        max_distance: int = 128) -> np.ndarray:
    """Bidirectional bucket table ``[T, T]`` (HF
    ``_relative_position_bucket``), host numpy: static per length."""
    ctx = np.arange(t)[:, None]
    mem = np.arange(t)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / math.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(n < max_exact, n, large)
    return buckets


class _T5Block(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.num_heads, self.d_kv = c.num_heads, c.d_kv
        self.attention_ln = RMSNorm(c.d_model, c.layer_norm_eps)
        self.q = Dense(c.d_model, inner, bias=False)
        self.k = Dense(c.d_model, inner, bias=False)
        self.v = Dense(c.d_model, inner, bias=False)
        self.o = Dense(inner, c.d_model, bias=False)
        self.ffn_ln = RMSNorm(c.d_model, c.layer_norm_eps)
        self.wi_0 = Dense(c.d_model, c.d_ff, bias=False)
        self.wi_1 = Dense(c.d_model, c.d_ff, bias=False)
        self.wo = Dense(c.d_ff, c.d_model, bias=False)

    def forward(self, x, position_bias):
        b, t, _ = x.shape
        ln = self.attention_ln(x)

        def heads(v):
            return v.reshape(b, t, self.num_heads, self.d_kv).transpose(1, 2)

        # no 1/sqrt(d) on the scores (T5)
        o = _softmax_attention(heads(self.q(ln)), heads(self.k(ln)),
                               heads(self.v(ln)), position_bias)
        x = x + self.o(o.transpose(1, 2).reshape(b, t, -1))
        ln2 = self.ffn_ln(x)
        y = F.gelu(self.wi_0(ln2), approximate="tanh") * self.wi_1(ln2)
        return x + self.wo(y)


class T5Encoder(nn.Module):
    """``forward(ids [B, T]) -> last hidden [B, T, d_model]`` (no attention
    mask, as diffusers calls SD3's T5).  Weights as
    :class:`CLIPTextEncoder`'s, made on ``device``: the XXL encoder's 4.7 B
    parameters are never made on the host."""

    def __init__(self, config: T5Config = T5_XXL, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        c = self.config = config
        with dev:
            self.token_embedding = Embed(c.vocab_size, c.d_model)
            self.rel_bias = Embed(c.relative_attention_num_buckets,
                                  c.num_heads)
            for i in range(c.num_layers):
                self.add_module(f"blocks_{i}", _T5Block(c))
            self.final_layer_norm = RMSNorm(c.d_model, c.layer_norm_eps)
        self._buckets = {}
        _init_weights(self, seed)

    def forward(self, input_ids):
        c = self.config
        t = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        key = (t, input_ids.device)
        if key not in self._buckets:
            self._buckets[key] = torch.as_tensor(t5_relative_buckets(
                t, c.relative_attention_num_buckets,
                c.relative_attention_max_distance), device=input_ids.device)
        # one bias [1, H, T, T] for every layer
        position_bias = self.rel_bias(self._buckets[key]).permute(2, 0, 1)[None]
        for i in range(c.num_layers):
            x = getattr(self, f"blocks_{i}")(x, position_bias)
        return self.final_layer_norm(x)


@torch.no_grad()
def _init_weights(model: nn.Module, seed: int):
    """The JAX init's layout on the model's device: kernels and embeddings
    N(0, 1/fan_in) (an embedding's fan-in is its width, flax's
    ``variance_scaling(1, "fan_in")`` on ``[num, dim]`` reads the first
    axis as out), biases 0, norm scales 1."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, prm in model.named_parameters():
        if name.endswith("scale"):
            prm.fill_(1.0)
        elif name.endswith("bias"):
            prm.zero_()
        elif name.endswith("embedding"):
            prm.normal_(0.0, 1.0 / math.sqrt(prm.shape[-1]), generator=gen)
        else:
            prm.normal_(0.0, 1.0 / math.sqrt(math.prod(prm.shape[:-1])),
                        generator=gen)


def t5_torch_path_map(path: tuple[str, ...]) -> str:
    """Flax (and port) path -> HF ``T5EncoderModel`` dotted key prefix (JAX
    ``models/text_encoders.py:271``)."""
    parts = []
    for seg in path:
        if seg.startswith("blocks_"):
            parts.append("encoder.block." + seg[len("blocks_"):])
        elif seg == "token_embedding":
            parts.append("shared")
        elif seg == "rel_bias":
            parts.append(
                "encoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias")
        elif seg == "attention_ln":
            parts.append("layer.0.layer_norm")
        elif seg in ("q", "k", "v", "o"):
            parts.append("layer.0.SelfAttention." + seg)
        elif seg == "ffn_ln":
            parts.append("layer.1.layer_norm")
        elif seg in ("wi_0", "wi_1", "wo"):
            parts.append("layer.1.DenseReluDense." + seg)
        elif seg == "final_layer_norm":
            parts.append("encoder.final_layer_norm")
        else:
            parts.append(seg)
    return ".".join(parts)


# ---------------------------------------------------------------------------
# SD3 encode_prompt
# ---------------------------------------------------------------------------


def sd3_encode_prompt(clip_l, ids_l, clip_g, ids_g, t5=None, ids_t5=None,
                      joint_dim: int = 4096, max_sequence_length: int = 256):
    """diffusers ``StableDiffusion3Pipeline.encode_prompt`` on the port's
    encoders: ``(prompt_embeds [B, T_clip + T_t5, joint_dim], pooled [B,
    P_l + P_g])``.  The CLIP-L and CLIP-G penultimate states are
    concatenated and zero-padded to ``joint_dim``; without T5 diffusers
    still appends a ZERO block of ``max_sequence_length`` tokens (it changes
    the attention's normalization), as here (``0`` leaves it out)."""
    pl, pooled_l = clip_l(ids_l)
    pg, pooled_g = clip_g(ids_g)
    clip_embeds = torch.cat([pl, pg], dim=-1)
    if clip_embeds.shape[-1] > joint_dim:
        raise ValueError(
            f"clip hidden concat {clip_embeds.shape[-1]} exceeds "
            f"joint_dim {joint_dim}")
    clip_embeds = F.pad(clip_embeds, (0, joint_dim - clip_embeds.shape[-1]))
    if t5 is not None:
        t5_embeds = t5(ids_t5)
    else:
        t5_embeds = clip_embeds.new_zeros(
            (clip_embeds.shape[0], max_sequence_length, joint_dim))
    prompt = torch.cat([clip_embeds, t5_embeds.to(clip_embeds.dtype)], dim=1)
    return prompt, torch.cat([pooled_l, pooled_g], dim=-1)
