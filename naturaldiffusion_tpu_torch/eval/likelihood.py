"""Probability-flow ODE log-likelihood (bits/dim) with a Hutchinson trace
(port of ``naturaldiffusion_tpu/eval/likelihood.py``; the reference's
``deps/score_sde_pytorch/likelihood.py:26-113``): integrate the augmented
ODE d[x, log p]/dt from eps to T with the port's RK45
(``samplers/rk45.py``), estimate the drift's divergence with one probe
(Rademacher or Gaussian), add the prior log-density, convert to bits/dim.

The divergence is ``eps^T J eps`` by reverse mode, the reference's own
formulation (``torch.autograd.grad`` of ``<drift(x), eps>``), through the
kernels' Functions on the card.  JAX takes ``jax.jvp`` (forward mode)
under its XLA convs, since forward mode cannot cross its custom-VJP
kernels; the two give the same number.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..samplers.rk45 import rk45_integrate
from ..sde import SDE


def get_div_fn(drift_fn: Callable):
    """``div_fn(x, t, eps) -> [B]``: ``sum(eps * J eps)`` per sample, J the
    Jacobian of ``drift_fn(., t)`` at x, by one reverse-mode product."""
    def div_fn(x, t, eps):
        eps = eps.to(x.dtype)
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            out = drift_fn(xg, t)
            jt_eps, = torch.autograd.grad((out * eps).sum(), xg)
        return (jt_eps * eps).reshape(x.shape[0], -1).sum(-1)
    return div_fn


def get_likelihood_fn(sde: SDE, score_fn, *,
                      hutchinson_type: str = "rademacher",
                      rtol: float = 1e-5, atol: float = 1e-5,
                      eps: float = 1e-5,
                      inverse_scaler: Callable = lambda x: x):
    """Returns ``likelihood_fn(generator, data, probe=None) -> (bpd, z,
    nfe)``.

    ``data`` is the scaled model-space input, its type the integration's
    (float64 for parity runs on the CPU); ``inverse_scaler`` maps back to
    [0, 1] for the dequantization offset (reference
    ``likelihood.py:94-105``).  The probe is drawn from ``generator``
    unless given (a test feeds JAX's)."""
    if hutchinson_type not in ("gaussian", "rademacher"):
        raise ValueError(hutchinson_type)
    rsde = sde.reverse(score_fn, probability_flow=True)

    def drift_fn(x, t):
        return rsde.sde(x, t)[0]

    div_fn = get_div_fn(drift_fn)

    @torch.no_grad()
    def likelihood_fn(generator, data, probe=None):
        shape = data.shape
        b = shape[0]
        if probe is None:
            probe = torch.randn(shape, generator=generator,
                                device=data.device)
            if hutchinson_type == "rademacher":
                probe = torch.randint(0, 2, shape, generator=generator,
                                      device=data.device) * 2.0 - 1.0
        probe = probe.to(data.dtype)
        dims = math.prod(shape[1:])

        def ode_fn(state, t):
            x = state[:, :dims].reshape(shape)
            tb = torch.full((b,), t, dtype=state.dtype, device=state.device)
            dx = drift_fn(x, tb).reshape(b, -1)
            dlogp = div_fn(x, tb, probe)[:, None]
            return torch.cat([dx, dlogp], dim=1)

        init = torch.cat([data.reshape(b, -1),
                          torch.zeros((b, 1), dtype=data.dtype,
                                      device=data.device)], dim=1)
        out, nfe = rk45_integrate(ode_fn, init, eps, sde.T, rtol=rtol,
                                  atol=atol)
        z = out[:, :dims].reshape(shape)
        delta_logp = out[:, dims]
        prior_logp = sde.prior_logp(z)
        bpd = -(prior_logp + delta_logp) / math.log(2) / dims
        # dequantization offset (reference likelihood.py:100-104: 7 for
        # centered data, 8 for uncentered): 8 + log2 of the inverse
        # scaler's per-dim Jacobian
        offset = 8.0 + _inverse_scaler_log_det(inverse_scaler)
        return bpd + offset, z, nfe

    return likelihood_fn


def _inverse_scaler_log_det(inverse_scaler) -> float:
    """log2 of the per-dim Jacobian of the (affine) inverse scaler, probed
    directly: centered data has scale 1/2 -> -1, uncentered scale 1 -> 0."""
    a = float(inverse_scaler(torch.tensor(0.0, dtype=torch.float64)))
    b = float(inverse_scaler(torch.tensor(1.0, dtype=torch.float64)))
    return math.log2(abs(b - a)) if b != a else 0.0
