"""Natural-Inference engine (port of ``naturaldiffusion_tpu/engine/ni.py``).

Every sampler is data: a :class:`CoeffMatrix` whose rows weigh the past
predicted x0's and the noises.  The JAX package runs the steps as one jitted
``lax.scan`` over a carried buffer; here one Python loop fills preallocated
``[n, M]`` buffers in place, and each step's dual weighted sum is the
fused kernel (``ops.weighted_sum.fused_weighted_sum``) on a CUDA tensor, its
plain version on a CPU one.  The buffers hold ``accum_dtype``: float32, or
float64 on the CPU only (the kernel sums in float32).  All
injected noises are drawn up front (column 0 of the eps matrix is the initial
noise), so the loop itself draws no random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..coeffs.matrix import CoeffMatrix
from ..device import resolve_device
from ..ops.weighted_sum import fused_weighted_sum
from ..utils.profiling import span
from .predictions import to_x0


@dataclasses.dataclass(frozen=True)
class NISchedule:
    """A CoeffMatrix as float32 (or ``dtype``) tensors on one device."""

    x0: torch.Tensor        # [n, n] lower-triangular
    eps: torch.Tensor       # [n, n+1]
    node: torch.Tensor      # [n+1, 3] (t, alpha, sigma)
    deterministic: bool = False   # True if eps[:, 1:] == 0

    @classmethod
    def from_matrix(cls, m: CoeffMatrix, device="cuda",
                    dtype=torch.float32) -> "NISchedule":
        dev = resolve_device(device)

        def cast(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return cls(x0=cast(m.x0), eps=cast(m.eps), node=cast(m.node),
                   deterministic=m.is_deterministic)

    @property
    def num_step(self) -> int:
        return self.x0.shape[0]


@torch.no_grad()
def natural_inference(
    denoise_fn: Callable,
    sched: NISchedule,
    init_noise: torch.Tensor,
    *,
    noises: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    prediction_type: str = "x0",
    model_dtype: torch.dtype | None = None,
    accum_dtype: torch.dtype = torch.float32,
    step_inputs=None,
) -> torch.Tensor:
    """Run Natural Inference; returns the final state ``z`` in
    ``accum_dtype``.

    ``denoise_fn(x, t) -> pred``: the batched network, called with x in
    ``model_dtype`` (default: init_noise's) and the node time ``t`` as a
    0-d float32 tensor; ``pred`` is converted to x0 by ``prediction_type``.
    ``init_noise``: ``[B, ...]`` prior sample (eps column 0).
    ``noises``: ``[n, B, ...]`` injected noises (columns 1..n); drawn from
    ``generator`` when omitted; unused for deterministic schedules.
    ``step_inputs``: per-step model inputs, a tensor or nested dicts,
    tuples and lists of tensors, each with a leading ``[n]`` axis (e.g.
    :func:`..models.dit.dit_schedule_mods`).  When given, the model is
    called as ``denoise_fn(x, t, aux_k)`` with step k's slice, as the JAX
    engine does.
    ``accum_dtype``: float32, or float64 for parity runs on the CPU; a
    CUDA tensor with float64 raises, as kernel K1 sums in float32.

    Reference loop shape: ``src/ValidateNaturalInference.py:345-366``.
    """
    n = sched.num_step
    shape = tuple(init_noise.shape)
    dev = init_noise.device
    model_dtype = model_dtype or init_noise.dtype
    acc = accum_dtype
    if acc not in (torch.float32, torch.float64):
        raise ValueError(f"accum_dtype must be float32 or float64, got {acc}")
    if acc == torch.float64 and dev.type != "cpu":
        raise ValueError("accum_dtype=float64 runs on the CPU only: kernel "
                         "K1 sums in float32")
    m = init_noise.numel()

    z = init_noise.to(acc).reshape(-1)     # x at node 0 IS the prior sample
    if sched.deterministic:
        bufe = z.reshape(1, m).clone()
    else:
        if noises is None:
            if generator is None:
                raise ValueError("stochastic schedule needs `noises` or "
                                 "`generator`")
            noises = torch.randn((n,) + shape, generator=generator,
                                 device=dev, dtype=acc)
        if tuple(noises.shape) != (n,) + shape:
            raise ValueError(f"noises {tuple(noises.shape)} != "
                             f"{(n,) + shape}")
        bufe = torch.cat([z.reshape(1, m),
                          noises.to(device=dev, dtype=acc).reshape(n, m)])
    eps_cols = bufe.shape[0]
    wx = sched.x0.to(acc).contiguous()
    we = sched.eps[:, :eps_cols].to(acc).contiguous()
    # rows at and past the live count k+1 are never read, so no zero fill
    bufx = torch.empty((n, m), dtype=acc, device=dev)

    for k in range(n):
        with span("ni.step"):
            t, alpha, sigma = sched.node[k]
            z_img = z.reshape(shape)
            if step_inputs is None:
                pred = denoise_fn(z_img.to(model_dtype), t)
            else:
                pred = denoise_fn(z_img.to(model_dtype), t,
                                  _at_step(step_inputs, k))
            x0 = to_x0(pred, z_img, alpha, sigma, prediction_type,
                       accum_dtype=acc)
            bufx[k] = x0.reshape(-1)   # in place: row k of the x0 buffer
            z = fused_weighted_sum(wx[k], we[k], bufx, bufe, k + 1,
                                   min(eps_cols, k + 2))
    return z.reshape(shape)


@torch.no_grad()
def natural_inference_checked(denoise_fn, sched: NISchedule, init_noise,
                              **kwargs) -> torch.Tensor:
    """NaN-guarded NI: :func:`natural_inference` (same arguments), then one
    check on the host after the loop.  A poisoned schedule or a diverging
    model raises ``FloatingPointError`` instead of emitting non-finite
    samples (JAX runs the scan under ``checkify`` and throws)."""
    out = natural_inference(denoise_fn, sched, init_noise, **kwargs)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("natural_inference produced non-finite "
                                 "output")
    return out


def _at_step(tree, k: int):
    """Step ``k``'s slice of every tensor in ``tree`` (dicts, tuples and
    lists of tensors), as ``jax.tree.map(lambda a: a[k], tree)``."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    if isinstance(tree, dict):
        return {key: _at_step(v, k) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_at_step(v, k) for v in tree)
    raise TypeError(f"step_inputs leaves must be tensors, got {type(tree)}")


@torch.no_grad()
def natural_inference_reference(
    denoise_fn, matrix: CoeffMatrix, init_noise: np.ndarray,
    *, noises: np.ndarray | None = None, prediction_type: str = "x0",
) -> np.ndarray:
    """Plain NumPy float64 NI loop, structurally identical to the reference
    (``src/ValidateNaturalInference.py:345-366``): the engine's oracle.
    A stochastic matrix without ``noises`` draws step k's noise from
    ``np.random.default_rng(1000 + k)``, as the JAX package's does."""
    n = matrix.num_step
    seq_eps = [np.asarray(init_noise, np.float64)]
    seq_x0: list[np.ndarray] = []
    z = seq_eps[0]
    for k in range(n):
        t, alpha, sigma = matrix.node[k]
        pred = np.asarray(denoise_fn(z, t), np.float64)
        if prediction_type == "eps":
            x0 = (z - sigma * pred) / alpha
        elif prediction_type == "x0":
            x0 = pred
        elif prediction_type == "v_flow":
            x0 = z - sigma * pred
        else:
            raise ValueError(prediction_type)
        seq_x0.append(x0)
        if not matrix.is_deterministic:
            if noises is not None:
                seq_eps.append(np.asarray(noises[k], np.float64))
            else:
                seq_eps.append(np.random.default_rng(1000 + k)
                               .standard_normal(z.shape))
        next_x0 = sum(matrix.x0[k, j] * seq_x0[j] for j in range(k + 1))
        next_eps = sum(matrix.eps[k, j] * seq_eps[j]
                       for j in range(min(len(seq_eps), k + 2)))
        z = next_x0 + next_eps
    return z
