"""FLOP counts for auditable MFU (port of
``naturaldiffusion_tpu/utils/flops.py``).

The JAX package reads its count from XLA's cost analysis of the lowered
program, or from a CPU subprocess when the TPU backend cannot analyse it.
PyTorch runs eagerly, so the port counts what a run executes:
:func:`flops_counted` runs a function under
``torch.utils.flop_counter.FlopCounterMode``.  The counter sees PyTorch
operators only (matrix products, convolutions, attention), never the port's
CUDA kernels, which are launched through ctypes; so the count is taken on
the CPU, where every kernel runs as its plain PyTorch version.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet), at 700 W
H100_BF16_PEAK = 989e12
# the same card's dense int8 tensor-core peak (data sheet), operations/s
H100_INT8_PEAK = 1979e12


def flops_counted(fn, *args, with_grad: bool = False, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` as PyTorch's counter sees them
    (2 per multiply-add of each product), under ``torch.no_grad`` unless
    ``with_grad`` (a train step: its backward's products count too).
    Every tensor argument must lie on the CPU: on the card the kernels
    would be invisible to the count."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            raise ValueError(f"flops_counted counts on the CPU, got a tensor "
                             f"on {a.device}")
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(with_grad):
        fn(*args, **kwargs)
    return counter.get_total_flops()


def flops_via_cpu_subprocess(module: str, argv: list[str]) -> float:
    """Run ``python -m <module> --flops-only <argv>`` in a fresh process on
    the CPU and parse the one number it prints last.

    ``NATDIFF_QUANT`` is stripped from the child's environment, as in the
    JAX package: the count is of the same math either way, and the
    quantized products are kernels the counter does not see."""
    env = {k: v for k, v in os.environ.items() if k != "NATDIFF_QUANT"}
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", module, "--flops-only", *argv],
        capture_output=True, text=True, check=True, env=env)
    return float(out.stdout.strip().splitlines()[-1])
