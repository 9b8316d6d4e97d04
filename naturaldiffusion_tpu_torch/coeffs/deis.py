"""DEIS (Diffusion Exponential Integrator Sampler) coefficient machinery.

Copy of ``naturaldiffusion_tpu/coeffs/deis.py`` (numpy only), kept here so the
port never imports the JAX package.

Two parts:

1. ``ab_coefficients`` — Adams-Bashforth exponential-integrator coefficients
   by numerical quadrature of Lagrange basis polynomials against the
   eps-integrand, with the recursive lower-order warm-up for the first steps
   (reference: ``deps/th_deis/multistep.py:6-96``).  Vectorized float64 numpy
   (the reference runs the same 10k-point left-Riemann sums in fp32 JAX).

2. ``derive_deis_tab`` — affine replay of the t-AB sampler to produce the
   Natural-Inference coefficient matrix (reference: ``src/AnalyzeDEIS.py:90-138``
   replaying ``deps/th_deis/sampler.py`` ``get_sampler_t_ab``).  Regression
   oracle: ``results/deis/deis_tab_{100,200}.npz`` (fp32-derived, so compared
   at a looser tolerance).
"""

from __future__ import annotations

import numpy as np

from ..affine import AffineTracker
from ..schedules import LinearVPSDE, deis_rev_ts
from .assemble import Node, assemble
from .matrix import CoeffMatrix

_KEY = "%0.4f"


# ---------------------------------------------------------------------------
# Adams-Bashforth exponential-integrator coefficients
# ---------------------------------------------------------------------------


def _lagrange_basis(tau: np.ndarray, ts_poly: np.ndarray) -> np.ndarray:
    """[num_item, k] matrix of Lagrange basis polynomials l_j(tau) over the
    interpolation nodes ``ts_poly`` (``deps/th_deis/multistep.py:18-31``)."""
    k = len(ts_poly)
    num = tau[:, None] - ts_poly[None, :]          # [m, k]
    out = np.empty((len(tau), k))
    for j in range(k):
        sel = np.ones(k, dtype=bool)
        sel[j] = False
        denom = np.prod(ts_poly[j] - ts_poly[sel])
        out[:, j] = np.prod(num[:, sel], axis=1) / denom
    return out


def _step_coeffs(sde: LinearVPSDE, t_start: float, t_end: float,
                 ts_poly: np.ndarray, num_item: int = 10000) -> np.ndarray:
    """Quadrature of psi(tau, t_end) * eps_integrand(tau) * l_j(tau) dtau via
    a left-Riemann sum, matching the reference's grid exactly
    (``deps/th_deis/multistep.py:7-15,36-44``)."""
    dt = (t_end - t_start) / num_item
    tau = t_start + np.arange(num_item) * dt       # linspace(..., endpoint=False)
    ab_tau = sde.t2alpha(tau)
    psi = np.sqrt(sde.t2alpha(t_end) / ab_tau)
    # eps integrand: -1/2 dlog(alpha_bar)/dt / sqrt(1 - alpha_bar)
    integrand = -0.5 * sde.d_log_alpha_bar_dt(tau) / np.sqrt(1.0 - ab_tau)
    basis = _lagrange_basis(tau, ts_poly)          # [m, k]
    return (psi * integrand) @ basis * dt          # [k]


def ab_coefficients(sde: LinearVPSDE, highest_order: int,
                    timesteps: np.ndarray, order: int,
                    num_item: int = 10000) -> np.ndarray:
    """[n_steps, highest_order+1] AB eps-coefficients, newest-eps-first
    columns, with recursive lower-order warm-up for the first ``order`` steps
    (``deps/th_deis/multistep.py:75-96``)."""
    n = len(timesteps) - 1
    out = np.zeros((n, highest_order + 1))
    for i in range(n):
        k = min(i, order)                          # effective order at step i
        ts_poly = timesteps[i - k: i + 1]          # nodes t_{i-k}..t_i ascending index
        coefs = _step_coeffs(sde, timesteps[i], timesteps[i + 1], ts_poly,
                             num_item)
        # column j weights eps at t_{i-j}: newest first = reversed node order
        out[i, : k + 1] = coefs[::-1]
    return out


def deis_tab_coefficients(sde: LinearVPSDE, num_step: int, ab_order: int,
                          ts_order: float = 2.0, ts_phase: str = "t",
                          t0: float = 1e-3) -> tuple[np.ndarray, np.ndarray]:
    """(rev_ts [n+1], ab_coef [n, ab_order+2]) where ab_coef[:, 0] is the
    x-transition psi and the rest are eps coefficients, as consumed by
    ``ab_step`` (``deps/th_deis/sampler.py:15-49``)."""
    rev_ts = deis_rev_ts(sde, num_step, ts_order, ts_phase, t0=t0)
    x_coef = np.sqrt(sde.t2alpha(rev_ts[1:]) / sde.t2alpha(rev_ts[:-1]))
    eps_coef = ab_coefficients(sde, ab_order, rev_ts, ab_order)
    return rev_ts, np.concatenate([x_coef[:, None], eps_coef], axis=1)


# ---------------------------------------------------------------------------
# Natural-Inference matrix via affine replay of the t-AB sampler
# ---------------------------------------------------------------------------


def derive_deis_tab(num_step: int, ab_order: int = 3,
                    ts_order: float = 2.0) -> CoeffMatrix:
    sde = LinearVPSDE()
    rev_ts, ab_coef = deis_tab_coefficients(sde, num_step, ab_order, ts_order)

    tr = AffineTracker()
    x = tr.new_eps(_KEY % rev_ts[0])
    tr.add_item(f"x_{_KEY % rev_ts[0]}", x)

    # AB history of past eps predictions, newest first, seeded with x_T
    # (``deps/th_deis/sampler.py:34``: eps_pred = [xT]*ab_order)
    eps_hist = [x] * ab_order

    for i in range(num_step):
        t = rev_ts[i]
        alpha_t, sigma_t = sde.marginal_coeff(t)
        y_t = tr.new_y(_KEY % t)
        new_eps = (x - alpha_t * y_t) / sigma_t    # eps from predicted x0

        coefs = ab_coef[i]
        hist = [new_eps] + eps_hist
        x_new = coefs[0] * x
        for c, e in zip(coefs[1:], hist):
            x_new = x_new + c * e
        x, eps_hist = x_new, hist[:-1]
        tr.add_item(f"x_{_KEY % rev_ts[i + 1]}", x)

    nodes = []
    for t in rev_ts:
        alpha, sigma = sde.marginal_coeff(t)
        nodes.append(Node(t=float(t), key=_KEY % t,
                          alpha=float(alpha), sigma=float(sigma)))
        if t != rev_ts[0]:
            tr.new_eps(_KEY % t)                   # deterministic pad
    return assemble(tr, nodes)
