"""Parameter and activation sharding rules (port of
``naturaldiffusion_tpu/parallel/shardings.py``).

Strategy table (the JAX package's):

* **DP** -- batch dim over ``data``; parameters replicated.  Here the
  gradients are averaged over ``data`` by the train step
  (``train/state.py``), explicitly.
* **TP (Megatron-style)** -- DiT/MMDiT attention heads and MLP hidden dim
  over ``model``: qkv/fc1 column-parallel, proj/fc2 row-parallel.  The
  parameters become DTensors; DTensor's redistributions stand for the
  all-reduces that XLA inserts from the annotations.
* **SP** -- the token axis over ``model`` between blocks
  (:func:`constrain_tokens`, applied by the model's ``token_constraint``).
* **FSDP (ZeRO-3)** -- the whole train state sharded over ``data``
  (:func:`fsdp_sharding`): per-rank state bytes drop about mesh-size-fold.

The rules are JAX's regexes over flax paths; they match the port's
parameter names (which keep flax's) with ``.`` read as ``/``, e.g.
``blocks_0.attn.qkv.kernel`` as ``blocks_0/attn/qkv/kernel``.
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .mesh import NamedSharding, axis_size

# param-path regex -> PartitionSpec factory (JAX shardings.py:28-67)
_DIT_TP_RULES: list[tuple[str, callable]] = [
    # column-parallel: output dim sharded
    (r".*/attn/qkv/kernel$",   lambda: (None, "model")),
    (r".*/attn/qkv/bias$",     lambda: ("model",)),
    (r".*/mlp/fc1/kernel$",    lambda: (None, "model")),
    (r".*/mlp/fc1/bias$",      lambda: ("model",)),
    # row-parallel: input dim sharded, output replicated (a sum)
    (r".*/attn/proj/kernel$",  lambda: ("model", None)),
    (r".*/mlp/fc2/kernel$",    lambda: ("model", None)),
    # adaLN modulation: large [D, 6D] projections -- column-parallel
    (r".*/adaLN_modulation_1/kernel$", lambda: (None, "model")),
    (r".*/adaLN_modulation_1/bias$",   lambda: ("model",)),
]

# MMDiT (SD3): q/k/v + context q/k/v column-parallel (heads over
# `model`), output projections row-parallel, both MLPs column -> row, adaLN
# projections column-parallel
_MMDIT_TP_RULES: list[tuple[str, callable]] = [
    (r".*/attn_to_[qkv]/kernel$",        lambda: (None, "model")),
    (r".*/attn_to_[qkv]/bias$",          lambda: ("model",)),
    (r".*/attn_add_[qkv]_proj/kernel$",  lambda: (None, "model")),
    (r".*/attn_add_[qkv]_proj/bias$",    lambda: ("model",)),
    (r".*/attn_to_out_0/kernel$",        lambda: ("model", None)),
    (r".*/attn_to_add_out/kernel$",      lambda: ("model", None)),
    (r".*/ff_net_0_proj/kernel$",        lambda: (None, "model")),
    (r".*/ff_net_0_proj/bias$",          lambda: ("model",)),
    (r".*/ff_net_2/kernel$",             lambda: ("model", None)),
    (r".*/ff_context_net_0_proj/kernel$", lambda: (None, "model")),
    (r".*/ff_context_net_0_proj/bias$",  lambda: ("model",)),
    (r".*/ff_context_net_2/kernel$",     lambda: ("model", None)),
    (r".*/norm1_linear/kernel$",         lambda: (None, "model")),
    (r".*/norm1_linear/bias$",           lambda: ("model",)),
    (r".*/norm1_context_linear/kernel$", lambda: (None, "model")),
    (r".*/norm1_context_linear/bias$",   lambda: ("model",)),
]


def _named_tensors(params) -> dict:
    """name -> tensor of a module's parameters or of a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def flax_path(name: str) -> str:
    """The port's dotted parameter name as the rules read it."""
    return name.replace(".", "/")


def tp_sharding(params, mesh: DeviceMesh, rules, *,
                family: str = "model") -> dict:
    """name -> :class:`NamedSharding` of ``params`` (a module or a name ->
    tensor dict) from ``rules``; unmatched names replicated.  Warns when NO
    name matches: a silent all-replicated result almost always means the
    rules were applied to the wrong model family."""
    out, matched = {}, 0
    for name in _named_tensors(params):
        path = flax_path(name)
        spec = ()
        for pat, fn in rules:
            if re.match(pat, path):
                matched += 1
                spec = fn()
                break
        out[name] = NamedSharding(mesh, spec)
    if matched == 0:
        warnings.warn(
            f"tp_sharding: zero {family} TP rules matched any parameter — "
            "the tree is fully replicated. Wrong model family for these "
            "rules?", stacklevel=2)
    return out


def dit_tp_sharding(params, mesh: DeviceMesh) -> dict:
    """Megatron TP for DiT parameters (see ``_DIT_TP_RULES``)."""
    return tp_sharding(params, mesh, _DIT_TP_RULES, family="DiT")


def mmdit_tp_sharding(params, mesh: DeviceMesh) -> dict:
    """Megatron TP for MMDiT/SD3 parameters (see ``_MMDIT_TP_RULES``)."""
    return tp_sharding(params, mesh, _MMDIT_TP_RULES, family="MMDiT")


def replicate_tree(params, mesh: DeviceMesh) -> dict:
    return {k: NamedSharding(mesh, ()) for k in _named_tensors(params)}


def fsdp_spec(shape, n: int, axis: str = "data",
              min_size: int = 2 ** 14) -> tuple:
    """JAX's ZeRO-3 rule for one leaf: sharded on its largest dim that
    ``n`` divides; scalars, leaves under ``min_size`` elements and leaves
    with no divisible dim replicated (``()``)."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return ()
    cands = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not cands:
        return ()
    d = max(cands, key=lambda i: shape[i])
    spec = [None] * len(shape)
    spec[d] = axis
    return tuple(spec)


def tree_map(fn, tree):
    """``fn`` over every tensor of a tensor / dict / list / tuple /
    dataclass tree (the train state); other leaves kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def fsdp_sharding(tree, mesh: DeviceMesh, *, axis: str = "data",
                  min_size: int = 2 ** 14):
    """ZeRO-3 sharding tree (params, optimizer moments and EMA alike):
    every tensor leaf gets the :class:`NamedSharding` of :func:`fsdp_spec`;
    the tree keeps its structure.  Per-rank training-state bytes drop about
    the axis size; the train step gathers the parameters for the forward
    and reduce-scatters the gradients (``train/state.py``)."""
    n = axis_size(mesh, axis)
    return tree_map(lambda t: NamedSharding(
        mesh, fsdp_spec(t.shape, n, axis, min_size)), tree)


def apply_shardings(tree, shardings):
    """Place every tensor of ``tree`` by the matching leaf of
    ``shardings`` (the same structure, or a name -> sharding dict for a
    dict or a module): ``jax.device_put(tree, shardings)``.  A module's
    parameters are replaced in place by DTensor parameters and the module
    returned; a tree comes back as a new tree of DTensors."""
    if isinstance(tree, nn.Module):
        for name, sh in shardings.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(mod_name) if mod_name else tree
            p = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(sh.distribute(p.detach()),
                                            requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return shardings.distribute(tree)
    if isinstance(tree, dict):
        return {k: apply_shardings(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(apply_shardings(v, s)
                          for v, s in zip(tree, shardings))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: apply_shardings(getattr(tree, f.name),
                                    getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def constrain_tokens(tok, mesh: DeviceMesh, *, data_axis="data",
                     seq_axis="model"):
    """Megatron-SP boundary constraint: ``[B, T, D]`` redistributed to
    (data, model, -)."""
    return NamedSharding(mesh, (data_axis, seq_axis, None)).constrain(tok)


def full(x):
    """The global value of a DTensor (gathered), or ``x`` itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x
