"""Carry the JAX package's weights (NCSN++, DiT) into the port's models,
or fill them from a seed."""

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
    """Fill ``model`` (the port's ``NCSNpp`` or ``DiT``) from a flax param
    tree.

    ``params``: the ``["params"]`` tree of the JAX package's model as
    nested dicts of numpy arrays: NCSN++'s ``{"m0": {"kernel", "bias"},
    "m3": {"Conv_0": {...}, ...}, ...}`` (matched against ``model.layers``;
    with the VE options also the Fourier projection's ``W``, the pyramid
    GroupNorms and convs, ``Combine``'s ``Conv_0`` and the FIR convs'
    ``Conv2d_0.weight``),
    or DiT's ``{"x_embedder_proj": {"kernel" [p,p,C,D] HWIO, "bias"},
    "y_embedder_embedding_table": {"embedding"}, "blocks_0": {"attn":
    {"qkv": ...}, ...}, ...}`` (matched against the model itself; its
    LayerNorms have no params).  Names and layouts are the same on both
    sides, so each leaf is copied as it is.  With ``dtype`` the model is cast
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
    zero: GroupNorm scales ``1 + 0.1 N(0, 1)``, biases ``0.1 N(0, 1)``,
    other weights ``N(0, 1 / fan_in)``.  The JAX init zeroes the residual
    and head convs, which would hide a wrong conv from a check or a bench.
    Returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            elif leaf in ("bias", "b"):
                v = 0.1 * torch.randn(p.shape, generator=g)
            else:
                v = torch.randn(p.shape, generator=g) / math.sqrt(
                    math.prod(p.shape[:-1]))
            p.copy_(v)
    return model
