"""Seeded inputs and the comparison the checks use."""

from __future__ import annotations

import torch


def request_generator(seed: int, i: int, device) -> torch.Generator:
    """The generator of request ``i``'s inputs under ``--seed``: the same
    pair gives the same inputs, in the run and in its check."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + 7 * i + 1) % 2 ** 63)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in float64; inf where ``got`` is not
    finite."""
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float((g - w).norm() / w.norm())
