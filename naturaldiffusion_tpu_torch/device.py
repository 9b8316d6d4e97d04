"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card exists.

    Entry points default to ``"cuda"`` and never carry on quietly on the
    CPU: a caller without a card has to ask for ``device="cpu"``, which runs
    every kernel's plain PyTorch version instead.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
