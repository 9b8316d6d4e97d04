"""Carry weights into the port's models: a flax tree of the JAX package
(:func:`load_jax_params`), a torch checkpoint of the reference
(:func:`load_torch_checkpoint` + :func:`fill_from_torch`, the port of
``naturaldiffusion_tpu/models/convert.py``), or random from a seed
(:func:`randomize_`).

The port keeps the flax names and layouts, so a torch checkpoint takes
JAX's transposes (torch -> port):
  Conv2d  weight [O, I, kh, kw]  -> kernel [kh, kw, I, O]
  Linear  weight [O, I]          -> kernel [I, O]
  GroupNorm/LayerNorm weight     -> scale
  NIN.W [in, out], biases, embeddings: unchanged
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            _flatten(v, name + ".", out)
        else:
            out[name] = v


def load_jax_params(model, params, dtype: torch.dtype | None = None):
    """Fill ``model`` (the port's ``NCSNpp``, ``DDPM``, ``NCSNv2``,
    ``NCSNv2_128``, ``NCSNv2_256``, ``NCSN``, ``DiT``, ``MMDiT``,
    ``AutoencoderKL``, ``CLIPTextEncoder`` or ``T5Encoder``) from a flax
    param tree.

    ``params``: the ``["params"]`` tree of the JAX package's model as
    nested dicts of numpy arrays: NCSN++'s ``{"m0": {"kernel", "bias"},
    "m3": {"Conv_0": {...}, ...}, ...}`` (matched against ``model.layers``;
    with the VE options also the Fourier projection's ``W``, the pyramid
    GroupNorms and convs, ``Combine``'s ``Conv_0`` and the FIR convs'
    ``Conv2d_0.weight``), DDPM's walk the same way (its resampling convs
    ``m{i}_Conv_0``), the RefineNets' ``{"begin_conv": ..., "res1_0":
    {"normalize1": {"alpha", "gamma", "beta"}, "conv1": ...}, "refine1":
    ...}`` (NCSN's norms ``{"embed": {"embedding"}}``), or DiT's
    ``{"x_embedder_proj": {"kernel" [p,p,C,D] HWIO, "bias"},
    "y_embedder_embedding_table": {"embedding"}, "blocks_0": {"attn":
    {"qkv": ...}, ...}, ...}`` (the last two, and the SD3 models' trees,
    matched against the model itself; the LayerNorms of DiT and MMDiT have
    no params).  Names and layouts are the same on both sides, so each
    leaf is copied as it is.  With ``dtype`` the model is cast
    first (e.g. ``torch.bfloat16``).  Raises on a missing, extra or
    mis-shaped leaf.  Returns the model."""
    flat: dict[str, object] = {}
    _flatten(params, "", flat)
    if dtype is not None:
        model.to(dtype)
    # NCSN++ keeps its walk in ``layers``; DiT's modules sit on the model
    root = model.layers if isinstance(getattr(model, "layers", None),
                                      torch.nn.Module) else model
    own = dict(root.named_parameters())
    missing = sorted(own.keys() - flat.keys())
    extra = sorted(flat.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:8]}, "
                       f"extra {extra[:8]}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.asarray(flat[name])
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {a.shape} != port "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    return model


def randomize_(model, seed: int):
    """Every parameter of ``model`` random from ``seed``, in place, none
    zero: GroupNorm scales and InstanceNorm++'s ``gamma`` and ``alpha``
    ``1 + 0.1 N(0, 1)``, biases (and ``beta``) ``0.1 N(0, 1)``, other
    weights ``N(0, 1 / fan_in)``.  The JAX init zeroes the residual
    and head convs, which would hide a wrong conv from a check or a bench.
    Returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "gamma", "alpha"):
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            elif leaf in ("bias", "b", "beta"):
                v = 0.1 * torch.randn(p.shape, generator=g)
            else:
                v = torch.randn(p.shape, generator=g) / math.sqrt(
                    math.prod(p.shape[:-1]))
            p.copy_(v)
    return model


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def strip_prefixes(state_dict: Mapping[str, object],
                   prefixes=("module.", "model.")) -> dict:
    """Drop the DataParallel / EMA wrapper prefixes (the reference wraps
    the model in ``torch.nn.DataParallel``, ``models/utils.py:93``)."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


# buffers of the reference's modules, which its EMA does not track
_BUFFERS = ("sigmas", "num_batches_tracked", "running_mean", "running_var")


def load_torch_checkpoint(path: str) -> dict:
    """A torch ``.pth`` as a flat name -> numpy dict (on the CPU).

    The reference's training state ``{model, ema, optimizer, step}``
    (``deps/score_sde_pytorch/utils.py:7-28``) gives the EMA
    ``shadow_params``: they follow ``model.parameters()``, the state dict's
    order without its buffers, which come from ``model``; a shadow whose
    shape is not its parameter's raises (misalignment).  A DiT release
    ``{model, ema}`` of plain state dicts gives ``ema``; ``{model}`` gives
    ``model``; anything else is a bare state dict.  ``module.`` and
    ``model.`` prefixes are stripped.  Loads with ``weights_only=True``:
    tensors and plain containers, no code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "ema" in ckpt:
        ema = ckpt["ema"]
        if "shadow_params" in ema:
            model_sd = strip_prefixes(ckpt["model"])
            shadows = list(ema["shadow_params"])
            out, si = {}, 0
            for k, v in model_sd.items():
                if k.split(".")[-1] in _BUFFERS:
                    out[k] = _to_numpy(v)
                    continue
                if si >= len(shadows) or \
                        tuple(shadows[si].shape) != tuple(v.shape):
                    got = tuple(shadows[si].shape) if si < len(shadows) \
                        else "none left"
                    raise ValueError(f"EMA shadow/param misalignment at {k}: "
                                     f"{got} vs {tuple(v.shape)}")
                out[k] = _to_numpy(shadows[si])
                si += 1
            return out
        ckpt = ema
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: _to_numpy(v) for k, v in strip_prefixes(ckpt).items()}


def _torch_leaf_and_transform(path: tuple[str, ...]):
    """A port (flax) leaf name -> (torch leaf name, numpy transform)."""
    leaf = path[-1]
    if leaf == "kernel":
        return "weight", lambda a: (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                    else a.transpose(1, 0))
    if leaf in ("scale", "embedding"):
        return "weight", lambda a: a
    if leaf == "weight":              # FIRConv2d raw weight, stays 4D
        return "weight", lambda a: (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                    else a)
    return leaf, lambda a: a          # bias, W, b, ...


def ncsnpp_torch_path_map(path: tuple[str, ...]) -> str:
    """The default path map: names joined by ``.``, each ``m{i}`` of the
    NCSN++ walk as ``all_modules.{i}``."""
    parts = []
    for seg in path:
        if seg.startswith("m") and seg[1:].isdigit():
            parts.extend(["all_modules", seg[1:]])
        else:
            parts.append(seg)
    return ".".join(parts)


def fill_from_torch(model, state_dict: Mapping[str, object], path_map=None,
                    root: str = "") -> list[str]:
    """Fill ``model`` (the port's ``NCSNpp`` or ``DDPM``, their walks in
    ``layers``, a RefineNet of ``models.ncsnv2``, ``DiT``, or an SD3 model:
    ``MMDiT``, ``AutoencoderKL``, ``CLIPTextEncoder``, ``T5Encoder``) in
    place from a torch state dict, e.g. from :func:`load_torch_checkpoint`.

    Each parameter's module path goes through ``path_map`` (default
    :func:`ncsnpp_torch_path_map`; the others are ``models.ddpm.
    ddpm_torch_path_map``, ``models.ncsnv2.ncsnv2_torch_path_map``,
    ``models.dit.dit_torch_path_map``, ``models.mmdit.
    mmdit_torch_path_map``, ``models.vae.vae_torch_path_map`` and
    ``models.text_encoders.clip_torch_path_map`` / ``t5_torch_path_map``)
    to a torch key under ``root``, with
    JAX's transposes (InstanceNorm++'s ``alpha``, ``gamma`` and ``beta``
    keep their names, an ``embedding`` is a torch ``weight``).  Raises ``KeyError`` on a missing key and ``ValueError`` on
    a wrong shape; nothing is written unless every parameter is found.
    A path map may carry a ``missing(key, state_dict, shape)`` attribute
    that gives the port-layout value of a key the state dict lacks, or
    None to raise (``models.vae.vae_torch_path_map``: the 1x1
    ``quant_conv``/``post_quant_conv`` that SD3's VAE drops load as
    identity).  Returns the unused torch keys."""
    pm = path_map or ncsnpp_torch_path_map
    missing = getattr(pm, "missing", None)
    module = model.layers if isinstance(getattr(model, "layers", None),
                                        torch.nn.Module) else model
    values, used = {}, set()
    for name, p in module.named_parameters():
        path = tuple(name.split("."))
        torch_leaf, tf = _torch_leaf_and_transform(path)
        key = pm(path[:-1])
        key = f"{root}{key}.{torch_leaf}" if key else f"{root}{torch_leaf}"
        if key in state_dict:
            arr = tf(_to_numpy(state_dict[key]))
            used.add(key)
        else:
            arr = (missing(key, state_dict, tuple(p.shape)) if missing
                   else None)
            if arr is None:
                raise KeyError(f"port parameter {name} -> missing torch "
                               f"key {key!r}")
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{key}: torch {arr.shape} vs port "
                             f"{tuple(p.shape)} at {name}")
        values[name] = arr
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(values[name])))
    return [k for k in state_dict if k not in used]


def train_state_from_jax(tree, model):
    """The port's ``train.TrainState`` over ``model``'s own parameters from
    a JAX ``TrainState`` with numpy leaves (``jax.device_get`` of one made
    by the JAX package's ``make_train_step``): ``params`` (loaded by
    :func:`load_jax_params`), the optax chain's state (Adam's ``count``,
    ``mu`` and ``nu``, the learning-rate schedule's ``count``), the EMA's
    ``shadow``, ``num_updates``, ``decay`` and ``warmup``, and ``step``.
    The tensors land on the model's device in float32.  Read by attribute,
    so nothing of JAX or optax is imported."""
    from ..train.ema import EMA
    from ..train.losses import OptState
    from ..train.state import TrainState

    load_jax_params(model, tree.params)
    root = model.layers if isinstance(getattr(model, "layers", None),
                                      torch.nn.Module) else model
    prefix = "layers." if root is not model else ""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def tensors(subtree):
        flat: dict[str, object] = {}
        _flatten(subtree, "", flat)
        return [torch.from_numpy(np.array(flat[n[len(prefix):]],
                                          np.float32)).to(dev)
                for n in params]

    # the chain's states are named tuples: (clip, Adam, schedule)
    adam = next(s for s in tree.opt_state if "mu" in getattr(s, "_fields", ()))
    sched = next(s for s in tree.opt_state
                 if tuple(getattr(s, "_fields", ())) == ("count",))
    opt = OptState(int(adam.count), tensors(adam.mu), tensors(adam.nu),
                   int(sched.count))
    e = tree.ema
    ema = EMA(tensors(e.shadow), float(e.decay), int(e.num_updates),
              bool(e.warmup))
    return TrainState(int(tree.step), params, opt, ema)
