"""Model output -> predicted x0 (port of ``naturaldiffusion_tpu/engine/
predictions.py``).

The NI engine is parameterisation-agnostic: whatever the denoiser predicts
is converted to a predicted x0 before it enters the weighted-sum recursion,
in terms of the ideal marginal (alpha_t, sigma_t) of ``CoeffMatrix.node``.
The divisions are computed in ``accum_dtype`` (float32 by default; the
reference uses fp64).
"""

from __future__ import annotations

import torch

PREDICTION_TYPES = ("eps", "x0", "score", "v_flow", "v_vp")


def to_x0(pred, x, alpha, sigma, prediction_type: str,
          accum_dtype=torch.float32):
    """Convert a model output ``pred`` at state ``x`` into predicted x0,
    computed in ``accum_dtype`` (the engine's accumulation type)."""
    p = pred.to(accum_dtype)
    xt = x.to(accum_dtype)
    alpha = torch.as_tensor(alpha, dtype=accum_dtype, device=xt.device)
    sigma = torch.as_tensor(sigma, dtype=accum_dtype, device=xt.device)
    if prediction_type == "eps":
        return (xt - sigma * p) / alpha
    if prediction_type == "x0":
        return p
    if prediction_type == "score":
        # score = -eps/sigma  =>  x0 = (score*sigma^2 + x)/alpha
        return (p * sigma ** 2 + xt) / alpha
    if prediction_type == "v_flow":
        # rectified flow: x = (1-sigma) x0 + sigma eps, v = eps - x0
        return xt - sigma * p
    if prediction_type == "v_vp":
        return alpha * xt - sigma * p
    raise ValueError(f"unknown prediction_type {prediction_type!r}; "
                     f"expected one of {PREDICTION_TYPES}")


def from_x0(x0, x, alpha, sigma, prediction_type: str):
    """Inverse of :func:`to_x0` (used by tests and by model wrappers that
    must re-emit a different parameterisation)."""
    if prediction_type == "x0":
        return x0
    if prediction_type == "eps":
        return (x - alpha * x0) / sigma
    if prediction_type == "score":
        return (alpha * x0 - x) / sigma ** 2
    if prediction_type == "v_flow":
        return (x - x0) / sigma
    if prediction_type == "v_vp":
        return (alpha * x - x0) / sigma
    raise ValueError(f"unknown prediction_type {prediction_type!r}")
