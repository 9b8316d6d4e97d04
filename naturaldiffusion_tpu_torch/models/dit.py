"""DiT, the Diffusion Transformer, in PyTorch, NHWC (port of
``naturaldiffusion_tpu/models/dit.py``, itself a rebuild of
``deps/DiT/models.py:27-372``; DiT-XL/2 is the ImageNet-256 backbone of
``src/ValidateNaturalInference.py:336-343``).

Modules and parameters keep the flax names (``x_embedder_proj``,
``t_embedder_mlp_0/2``, ``y_embedder_embedding_table.embedding``,
``blocks_{i}.attn.qkv``, ``blocks_{i}.mlp.fc1``, ``blocks_{i}.adaLN_
modulation_1``, ``final_layer.linear``; ``kernel`` [in, out], the patchify
conv kernel [p, p, C, D]), so :func:`.convert.load_jax_params` carries a
flax tree across as it is.

Attention runs kernel K9 on the card (``ops.attention.mha``).  With
``quant="w8"`` (what ``NATDIFF_QUANT=w8`` selects in both packages) every
``QDense`` whose ``(M, K, N)`` passes ``qmatmul_ok`` runs kernel K7
(``ops.qmatmul.matmul_wdq``) on int8 weights quantized once from the
weights in their current type.  The float ``QDense``, the adaLN and final
``Dense`` and the patchify are plain products (``torch.matmul``), as the
JAX package leaves them to XLA.  Dense layers compute in the promoted type
of input and weights, LayerNorm keeps f32 statistics with flax's
``E[x^2] - E[x]^2`` variance, and GELU is the tanh form, all as flax does.
``forward(..., train=True)`` drops labels to the null class with
``class_dropout_prob`` (JAX ``models/dit.py:243-248``), drawn from an
explicit generator or the given ``drop`` mask.  ``dit_torch_path_map`` maps
the names to a DiT release checkpoint's for ``convert.fill_from_torch``.

Sharding (JAX ``models/dit.py:99-117,200-211,260-262``): the parameters may
be DTensors (``parallel.dit_tp_sharding``, Megatron TP over ``model``) and
the input a batch-sharded DTensor (``parallel.shard_batch``); the forward
then runs on DTensors, plain tensors (the position table, the sinusoid's
frequencies) counting as replicated.  ``token_constraint`` (a
``parallel.NamedSharding`` of ``[B, T, D]``, e.g. (data, model, -))
redistributes the tokens at every block boundary (Megatron SP).  Two
boundaries are explicit: the packed qkv and the 6-way adaLN modulation are
gathered over their feature dim before they are split (DTensor cannot
unflatten a column-sharded packed dim), and attention runs on local
tensors: each rank takes its batch rows and, under TP, its heads
(``to_local`` / ``from_local``), so kernel K9 never sees a DTensor.
``attn_backend="ring"`` with ``mesh`` runs ring attention over ``mesh``'s
``model`` axis (``ops.ring_attention``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import attention as A
from ..ops._autograd import is_dtensor
from ..ops import qmatmul as Q
from ..ops.quant import quantize_weight

QUANT_MODES = (None, "w8")


def timestep_embedding(t, dim: int, max_period: int = 10000):
    """GLIDE-style sinusoidal embedding, cos first, ``/half`` frequency
    denominator (``deps/DiT/models.py:40-60``), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """MAE 2-D sin/cos table (``deps/DiT/models.py:279-330``), float64,
    ``[grid_size**2, embed_dim]``; the meshgrid puts w first."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)   # w first
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x, eps: float = 1e-6):
    """flax ``LayerNorm(use_bias=False, use_scale=False)``: statistics in
    float32 with ``var = max(E[x^2] - E[x]^2, 0)``, output in x's type."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _promote(x, p):
    return torch.promote_types(x.dtype, p.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]`` (none with
    ``bias=False``, flax's ``use_bias=False``); the product and the bias add
    run in the promoted type of input and weights."""

    def __init__(self, fin: int, fout: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fin, fout))
        if bias:
            self.bias = nn.Parameter(torch.empty(fout))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        dt = _promote(x, self.kernel)
        y = tokens_whole(x).to(dt) @ self.kernel.to(dt)
        return grad_as_forward(y if self.bias is None
                               else y + self.bias.to(dt))


class QDense(Dense):
    """``Dense`` with the weight-only int8 path.

    With ``quant == "w8"`` and ``qmatmul_ok(M, K, N)`` the product runs on
    ``(w_i8, s_w) = quantize_weight(kernel in the compute type)``, made once
    per state of the kernel and kept beside it (not a parameter or buffer),
    with ``pack_weight(w_i8)``, the form kernel K7 reads: the same
    bf16-rounded weights give the same int8 values as the JAX package's
    in-graph quantization.  The gate is checked per call, since M depends
    on the batch."""

    def __init__(self, fin: int, fout: int):
        super().__init__(fin, fout)
        self.quant = None
        self._q_key = None
        self._q = None
        self._packed = None

    def _quantized(self, dt):
        k = self.kernel
        # an inference-mode tensor keeps no version counter
        ver = None if k.is_inference() else k._version
        key = (k.data_ptr(), k.dtype, k.device, ver, dt)
        if self._q_key != key:
            with torch.no_grad():
                w_i8, s_w = quantize_weight(k.to(dt), axis=-1)
                b32 = self.bias.to(dt).to(torch.float32)
                self._packed = Q.pack_weight(w_i8).contiguous()
            self._q, self._q_key = (w_i8, s_w.reshape(-1), b32), key
        return self._q

    def forward(self, x):
        if self.quant == "w8":
            kk, n = self.kernel.shape
            if Q.qmatmul_ok(x.numel() // kk, kk, n):
                dt = _promote(x, self.kernel)
                w_i8, s_w, b32 = self._quantized(dt)
                return Q.matmul_wdq(x.to(dt), w_i8, s_w, b32, self._packed)
        return super().forward(x)


def batch_only(x):
    """A DTensor redistributed to keep only its batch (dim 0) sharding,
    every other dim whole on each rank; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def tokens_whole(x):
    """A DTensor whose token dim (any dim between the batch and the
    features) is sharded, gathered over it: the SP -> TP boundary, where
    the sequence enters a product whole, as XLA gathers it into the TP
    matmuls.  Anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mid = [isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
           for p in x.placements]
    if not any(mid):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if m else p for p, m in zip(x.placements, mid)])


def grad_as_forward(y):
    """A DTensor whose gradient arrives in its forward placements: the
    product's backward then flattens a gradient that shards no token dim
    (DTensor refuses to flatten one that does, e.g. after the residual add
    of a token-sharded stream).  Anything else as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import DTensor, Replicate
    # a partial sum's gradient is the whole gradient on every rank
    grad_pl = [Replicate() if p.is_partial() else p for p in y.placements]
    return DTensor.from_local(y.to_local(grad_placements=grad_pl),
                              y.device_mesh, y.placements, run_check=False)


def _tp_axis(kernel):
    """The mesh dim over which a column-parallel kernel ``[in, out]`` is
    sharded, or None."""
    if is_dtensor(kernel):
        from torch.distributed.tensor import Shard
        for i, p in enumerate(kernel.placements):
            if p == Shard(1):
                return i
    return None


def sharded_forward(x):
    """The context a forward runs in: DTensor's implicit replication of
    plain tensors when ``x`` is a DTensor."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    from ..parallel.mesh import implicit_replication
    return implicit_replication()


class Attention(nn.Module):
    """timm-style multi-head attention (qkv bias, no dropout) over kernel
    K9 (``ops.attention.mha``).  ``attn_backend``/``mesh``: as
    :func:`..ops.attention.mha`'s ``backend``/``mesh``."""

    def __init__(self, dim: int, num_heads: int, attn_backend: str = "auto",
                 mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_backend = attn_backend
        self.mesh = mesh
        self.qkv = QDense(dim, 3 * dim)
        self.proj = QDense(dim, dim)

    def _mha(self, q, k, v):
        return A.mha(q, k, v, backend=self.attn_backend, mesh=self.mesh)

    def forward(self, x):
        b, t, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        if is_dtensor(qkv):
            return self.proj(self._local_attention(qkv))
        # reshape(b, t, 3, h, dh) as the JAX package splits it; q, k and v
        # stay strided views, which the kernel reads in place
        qkv = qkv.reshape(b, t, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = self._mha(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(b, t, d))

    def _local_attention(self, qkv):
        """Attention of a DTensor ``qkv``: gathered over its features and
        split into q, k, v; then :func:`local_attention`.  Returns the
        ``[B, T, D]`` DTensor, head-sharded under TP."""
        if self.attn_backend == "ring":
            raise NotImplementedError(
                "attn_backend='ring' runs on replicated parameters and a "
                "plain input (JAX's ring DiT); the TP-sharded DiT takes K9")
        b, t, d3 = qkv.shape
        h, d = self.num_heads, d3 // 3
        qkv = batch_only(qkv).reshape(b, t, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = local_attention(q, k, v, _tp_axis(self.qkv.kernel), self._mha)
        return y.reshape(b, t, d)


def local_attention(q, k, v, tp, attn):
    """``attn`` on local tensors for ``[B, H, T, dh]`` DTensors q, k, v
    that shard at most their batch: each rank takes its batch rows and,
    when ``tp`` names a mesh dim that divides the heads, its own heads of
    it.  Returns the ``[B, T, H, dh]`` DTensor (heads sharded over ``tp``).
    Under TP a rank's local gradient holds its own heads only, so the
    gradient that leaves is a partial sum over ``tp``."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh, placements = q.device_mesh, list(q.placements)
    h = q.shape[1]
    if tp is not None and h % mesh.size(tp):
        tp = None
    grad_pl = list(placements)
    if tp is not None:
        grad_pl[tp] = Partial()
    q, k, v = (a.to_local(grad_placements=grad_pl) for a in (q, k, v))
    if tp is not None:
        n, r = mesh.size(tp), mesh.get_local_rank(tp)
        q, k, v = (a[:, r * h // n:(r + 1) * h // n] for a in (q, k, v))
        placements[tp] = Shard(2)           # heads of [B, T, H, dh]
    y = attn(q, k, v).transpose(1, 2)
    return DTensor.from_local(y, mesh, placements, run_check=False)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = QDense(dim, hidden)
        self.fc2 = QDense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-Zero block (``deps/DiT/models.py:105-126``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_backend: str = "auto", mesh=None):
        super().__init__()
        self.adaLN_modulation_1 = Dense(dim, 6 * dim)
        self.attn = Attention(dim, num_heads, attn_backend, mesh)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, c, mods=None):
        mod = mods if mods is not None else self.adaLN_modulation_1(F.silu(c))
        mod = batch_only(mod)   # the 6-way split of a column-sharded dim
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
        x = x + g_a[:, None, :] * self.attn(
            modulate(layer_norm(x), sh_a, sc_a))
        return x + g_m[:, None, :] * self.mlp(
            modulate(layer_norm(x), sh_m, sc_m))


class FinalLayer(nn.Module):
    def __init__(self, dim: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation_1 = Dense(dim, 2 * dim)
        self.linear = Dense(dim, patch_size ** 2 * out_channels)

    def forward(self, x, c, mods=None):
        mod = mods if mods is not None else self.adaLN_modulation_1(F.silu(c))
        shift, scale = torch.chunk(batch_only(mod), 2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class PatchEmbed(nn.Module):
    """The ``p x p``, stride-``p`` VALID conv of flax (kernel HWIO
    ``[p, p, C, D]``), computed as patches times the flattened kernel."""

    def __init__(self, patch: int, cin: int, dim: int):
        super().__init__()
        self.patch = patch
        self.kernel = nn.Parameter(torch.empty(patch, patch, cin, dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        b, hh, ww, c = x.shape
        p = self.patch
        patches = x.reshape(b, hh // p, p, ww // p, p, c).transpose(2, 3)
        patches = patches.reshape(b, (hh // p) * (ww // p), p * p * c)
        dt = _promote(x, self.kernel)
        y = patches.to(dt) @ self.kernel.to(dt).reshape(p * p * c, -1)
        return y + self.bias.to(dt)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [num, dim]``."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, idx):
        return self.embedding[idx]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels


class DiT(nn.Module):
    """``forward(x [B,H,W,C], t [B], y [B] int, mods=None) ->
    [B, H, W, out_channels]``.

    Weights are random from ``seed``, laid out as the JAX package's init:
    kernels N(0, 1/fan_in), biases 0, the label table N(0, 0.02), and the
    adaLN-Zero modulations and final linear all zero (so the output is 0
    until weights are loaded or perturbed).  ``quant``: ``None`` or
    ``"w8"``, settable later through :meth:`set_quant`.  The module lands
    on ``device`` (default ``"cuda"``, which raises without a card).
    ``token_constraint``, ``attn_backend``, ``mesh``: the sharding hooks
    of the module docstring."""

    def __init__(self, config: DiTConfig, *, quant: str | None = None,
                 device="cuda", seed: int = 0, token_constraint=None,
                 attn_backend: str = "auto", mesh=None):
        super().__init__()
        if attn_backend == "ring" and mesh is None:
            raise ValueError("attn_backend='ring' needs a mesh")
        dev = resolve_device(device)
        if token_constraint is not None and not hasattr(
                token_constraint, "constrain"):
            raise TypeError(f"token_constraint must be a parallel."
                            f"NamedSharding, got {token_constraint!r}")
        self.token_constraint = token_constraint
        cfg = self.config = config
        d, p = cfg.hidden_size, cfg.patch_size
        self.x_embedder_proj = PatchEmbed(p, cfg.in_channels, d)
        self.t_embedder_mlp_0 = Dense(256, d)
        self.t_embedder_mlp_2 = Dense(d, d)
        n_embed = cfg.num_classes + (1 if cfg.class_dropout_prob > 0 else 0)
        self.y_embedder_embedding_table = Embed(n_embed, d)
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", DiTBlock(
                d, cfg.num_heads, cfg.mlp_ratio, attn_backend, mesh))
        self.final_layer = FinalLayer(d, p, cfg.out_channels)
        grid = cfg.input_size // p
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(d, grid).astype(np.float32)),
            persistent=False)
        self.to(dev)
        self._init_weights(seed)
        self.set_quant(quant)

    @property
    def blocks(self):
        return [getattr(self, f"blocks_{i}") for i in range(self.config.depth)]

    def set_quant(self, quant: str | None) -> "DiT":
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
        gen = torch.Generator(device=self.pos_embed.device).manual_seed(seed)
        zero = ("adaLN_modulation_1", "final_layer.linear")
        for name, prm in self.named_parameters():
            if name.endswith("bias") or any(z in name for z in zero):
                prm.zero_()
            elif name.endswith("embedding"):
                prm.normal_(0.0, 0.02, generator=gen)
            else:
                prm.normal_(0.0, 1.0 / math.sqrt(math.prod(prm.shape[:-1])),
                            generator=gen)

    def time_embedding(self, t):
        """The timestep MLP over the sinusoidal embedding; it runs in the
        promoted type of its f32 input and the weights (f32 in a bf16
        model), as flax does."""
        temb = self.t_embedder_mlp_0(timestep_embedding(t, 256))
        return self.t_embedder_mlp_2(F.silu(temb))

    def forward(self, x, t, y, mods=None, *, train: bool = False,
                generator: torch.Generator | None = None, drop=None):
        """``mods``: one step's slice of :func:`dit_schedule_mods`; when
        given, the embedders and every adaLN product are skipped and ``t``,
        ``y`` are ignored.  ``train`` with ``class_dropout_prob > 0``: each
        label becomes the null class ``num_classes`` where ``drop`` (a [B]
        bool mask) holds, or where a uniform draw from ``generator`` falls
        below the probability."""
        with sharded_forward(x):
            return self._forward(x, t, y, mods, train, generator, drop)

    def _forward(self, x, t, y, mods, train, generator, drop):
        cfg = self.config
        if train and cfg.class_dropout_prob > 0 and mods is None:
            if drop is None:
                drop = torch.rand(y.shape[0], generator=generator,
                                  device=y.device) < cfg.class_dropout_prob
            y = torch.where(drop.to(y.device), torch.full_like(
                y, cfg.num_classes), y)
        b, hh, ww, _ = x.shape
        p = cfg.patch_size
        tok = self.x_embedder_proj(x)
        tok = tok + self.pos_embed.to(tok.dtype)[None]
        c = None
        if mods is None:
            # cast to the token type, or every block promotes to f32
            c = (self.time_embedding(t)
                 + self.y_embedder_embedding_table(y)).to(tok.dtype)
        for i, blk in enumerate(self.blocks):
            if self.token_constraint is not None:
                tok = self.token_constraint.constrain(tok)
            tok = blk(tok, c, mods=None if mods is None else mods["blocks"][i])
        tok = self.final_layer(tok, c,
                               mods=None if mods is None else mods["final"])
        out = batch_only(tok).reshape(b, hh // p, ww // p, p, p,
                                      cfg.out_channels)
        return out.transpose(2, 3).reshape(b, hh, ww, cfg.out_channels)


@torch.no_grad()
def dit_schedule_mods(model: DiT, t_all, y, dtype=None):
    """Hoist DiT's schedule-constant conditioning out of the NI loop.

    With a static schedule and fixed labels, ``c = temb(t) + yemb(y)`` and
    every block's adaLN modulation are loop constants; this computes them
    for all steps in one product per layer, with the model's own modules.
    ``t_all``: [S] schedule times; ``y``: [B] int labels (the CFG-doubled
    vector).  Returns ``{"blocks": (mod [S, B, 6d], ...), "final":
    [S, B, 2d]}``, in ``dtype`` (default: the weights' type), for the
    engine's ``step_inputs=``."""
    cfg = model.config
    d = cfg.hidden_size
    s, b = t_all.shape[0], y.shape[0]
    if dtype is None:
        dtype = model.x_embedder_proj.kernel.dtype
    temb = model.time_embedding(t_all)
    yemb = model.y_embedder_embedding_table(y)
    c = (temb[:, None, :] + yemb[None]).to(dtype)          # [S, B, d]
    sc = F.silu(c).reshape(s * b, d)
    blocks = tuple(blk.adaLN_modulation_1(sc).reshape(s, b, -1)
                   for blk in model.blocks)
    final = model.final_layer.adaLN_modulation_1(sc).reshape(s, b, -1)
    return {"blocks": blocks, "final": final}


def forward_with_cfg(apply_fn, x, t, y, cfg_scale: float, in_channels: int):
    """The reference CFG wrapper, channels-last (``deps/DiT/models.py:
    255-272``): duplicates the first half of the batch, guides only the
    first ``in_channels`` output channels (eps), passes the rest (sigma)
    through."""
    half = x[: x.shape[0] // 2]
    out = apply_fn(torch.cat([half, half]), t, y)
    eps, rest = out[..., :in_channels], out[..., in_channels:]
    cond, uncond = torch.chunk(eps, 2, dim=0)
    half_eps = uncond + cfg_scale * (cond - uncond)
    return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=-1)


def _cfg(**kw) -> DiTConfig:
    return DiTConfig(**kw)


DIT_CONFIGS: dict[str, DiTConfig] = {
    "DiT-XL/2": _cfg(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "DiT-XL/4": _cfg(depth=28, hidden_size=1152, patch_size=4, num_heads=16),
    "DiT-XL/8": _cfg(depth=28, hidden_size=1152, patch_size=8, num_heads=16),
    "DiT-L/2": _cfg(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "DiT-L/4": _cfg(depth=24, hidden_size=1024, patch_size=4, num_heads=16),
    "DiT-L/8": _cfg(depth=24, hidden_size=1024, patch_size=8, num_heads=16),
    "DiT-B/2": _cfg(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "DiT-B/4": _cfg(depth=12, hidden_size=768, patch_size=4, num_heads=12),
    "DiT-B/8": _cfg(depth=12, hidden_size=768, patch_size=8, num_heads=12),
    "DiT-S/2": _cfg(depth=12, hidden_size=384, patch_size=2, num_heads=6),
    "DiT-S/4": _cfg(depth=12, hidden_size=384, patch_size=4, num_heads=6),
    "DiT-S/8": _cfg(depth=12, hidden_size=384, patch_size=8, num_heads=6),
}


def dit_torch_path_map(path: tuple[str, ...]) -> str:
    """Flax (and port) module path -> torch dotted key of the DiT release
    checkpoints (``DiT-XL-2-256x256.pt``), for
    :func:`.convert.fill_from_torch` (JAX ``models/dit.py:357``)."""
    parts = []
    for seg in path:
        if seg.startswith("blocks_"):
            parts.append("blocks." + seg[len("blocks_"):])
        elif seg == "x_embedder_proj":
            parts.append("x_embedder.proj")
        elif seg == "t_embedder_mlp_0":
            parts.append("t_embedder.mlp.0")
        elif seg == "t_embedder_mlp_2":
            parts.append("t_embedder.mlp.2")
        elif seg == "y_embedder_embedding_table":
            parts.append("y_embedder.embedding_table")
        elif seg == "adaLN_modulation_1":
            parts.append("adaLN_modulation.1")
        else:
            parts.append(seg)
    return ".".join(parts)
