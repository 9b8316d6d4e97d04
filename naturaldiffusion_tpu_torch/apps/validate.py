"""Natural-Inference consistency validation (port of
``naturaldiffusion_tpu/apps/validate.py``, the ``src/
ValidateNaturalInference.py`` twin).

For each algorithm it runs (a) the direct sampler recursion and (b)
Natural Inference with the derived coefficient matrix, from the same seed
and the same noises, and reports ``max|NI - direct|`` against ``--tol``
(default 1e-4).  A deterministic toy denoiser stands in for the network.
On the CPU both run in float64 (JAX runs this app with x64); on the card
in float32 through the NI kernel.

    python -m naturaldiffusion_tpu_torch.apps.validate --device cpu
    python -m naturaldiffusion_tpu_torch.apps.validate --alg ddpm --steps 10
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..coeffs import registry
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..samplers import direct

# algorithm -> (derivation, stochastic)
_DIRECT = {
    "ddpm": ("ddpm", True),
    "ddim": ("ddim", False),
    "ode_euler": ("ode_euler", False),
    "sde_euler": ("sde_euler", True),
    "ode_heun": ("ode_heun", False),
    "flow_euler": ("flow_euler", False),
}


def toy_x0(x, t):
    return torch.tanh(x) * 0.5 + 0.01 * torch.sin(t / 100.0) * x


def toy_x0_tfree(x, t):
    """Heun's NI matrix keys intermediate nodes at t + offset (SURVEY.md §7
    'hard parts'), so exact equivalence needs a t-insensitive denoiser."""
    return torch.tanh(x) * 0.5


def run_pair(alg: str, num_step: int, init, noises=None, *, x0_fn=toy_x0):
    """``(direct, NI)`` final states of ``alg`` from ``init`` [B, ...] (and
    ``noises`` [num_step, B, ...] for the stochastic ones), both in
    ``init``'s type on its device."""
    deriver, stochastic = _DIRECT[alg]
    if alg == "ode_heun":
        x0_fn = toy_x0_tfree
    dtype = init.dtype
    sched = NISchedule.from_matrix(registry.derive(deriver, num_step),
                                   device=init.device, dtype=dtype)
    ni = natural_inference(x0_fn, sched, init,
                           noises=noises if stochastic else None,
                           prediction_type="x0", accum_dtype=dtype)
    fn = getattr(direct, "ddpm_ancestral" if alg == "ddpm" else alg)
    args = (noises,) if stochastic else ()
    return fn(x0_fn, num_step, init, *args, dtype=dtype), ni


def validate(alg: str, num_step: int, *, batch: int = 4, size: int = 8,
             seed: int = 0, tol: float = 1e-4, device="cuda") -> float:
    """``max|NI - direct|`` of ``alg`` at ``num_step`` steps on an
    ``[batch, size, size, 3]`` state drawn from ``seed``; prints it beside
    ``tol``."""
    dev = resolve_device(device)
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, size, size, 3)
    init = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    noises = torch.randn((num_step,) + shape, generator=gen, device=dev,
                         dtype=dtype)
    dr, ni = run_pair(alg, num_step, init, noises)
    diff = float((ni - dr).abs().max())
    status = "OK " if diff < tol else "FAIL"
    print(f"[{status}] {alg:<12s} steps={num_step:<4d} "
          f"max|NI - direct| = {diff:.3e}", flush=True)
    return diff


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--alg", choices=sorted(_DIRECT), default=None)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    algs = [args.alg] if args.alg else sorted(_DIRECT)
    worst = max(validate(a, args.steps, tol=args.tol, device=args.device)
                for a in algs)
    return 0 if worst < args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
