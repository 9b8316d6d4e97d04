"""Every weight random from a seed, made on the device in one call a model.

The rule is that of ``randomize_dit_`` and ``randomize_``, which the
port's checks use so that no zero-initialised layer (adaLN-Zero, the
residual and head convs) hides a fault: norm scales ``1 + 0.1 N(0, 1)``,
biases ``0.1 N(0, 1)``, embedding tables ``0.02 N(0, 1)``, every other
weight ``N(0, 1 / fan_in)`` with ``fan_in`` the product of all but the last
axis.  The values are drawn as one flat tensor in the served type, in the
order of the parameters' sorted names, so a module with the same names and
shapes (the port's model, or the reference) gets the same values; each
parameter becomes a view of that tensor.
"""

from __future__ import annotations

import math

import torch
from torch import nn

SCALES = ("scale", "gamma", "alpha")
BIASES = ("bias", "b", "beta")


def leaf_rule(name: str, shape) -> tuple[float, float]:
    """``(std, mean)`` of the parameter ``name`` of ``shape``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in SCALES:
        return 0.1, 1.0
    if leaf in BIASES:
        return 0.1, 0.0
    if leaf == "embedding":
        return 0.02, 0.0
    return 1.0 / math.sqrt(math.prod(shape[:-1])), 0.0


def model_seed(seed: int, part: int) -> int:
    """The seed of a configuration's ``part``-th model, from ``--seed``."""
    return (seed * 16 + part) % 2 ** 63


def param_shapes(model: nn.Module) -> list[tuple[str, tuple]]:
    return sorted((n, tuple(p.shape)) for n, p in model.named_parameters())


@torch.no_grad()
def fill_(model: nn.Module, seed: int, dtype=torch.bfloat16,
          device="cuda", cast=None, rule=leaf_rule) -> nn.Module:
    """Replace every parameter of ``model`` by the seeded values in
    ``dtype`` on ``device`` (``cast``: a type to convert each to afterwards,
    the reference's float32; ``rule``: a model's own ``(std, mean)`` by
    name and shape, in place of :func:`leaf_rule`).  Returns the model."""
    named = sorted(model.named_parameters(), key=lambda kv: kv[0])
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    off = 0
    for name, p in named:
        n = p.numel()
        v = flat[off:off + n].view(p.shape)
        off += n
        std, mean = rule(name, p.shape)
        v.mul_(std)
        if mean:
            v.add_(mean)
        if cast is not None:
            v = v.to(cast)
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(v, requires_grad=False))
    return model
