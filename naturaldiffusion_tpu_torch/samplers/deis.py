"""DEIS, the Diffusion Exponential Integrator Samplers (port of
``naturaldiffusion_tpu/samplers/deis.py``, itself a rebuild of
``deps/th_deis/``): t-AB, rho-AB, rho-RK (8 tableaus) and iPNDM.

Contract: ``eps_fn(x, t)`` gets the step's time as a 0-d tensor of x's
type on x's device, as the reference's ``eps_fn(x, s_t)`` gets a scalar;
broadcast it over the batch in the wrapper (``(t * 999).expand(B)``).

The Adams-Bashforth tables are host float64 numpy (the quadrature of
:mod:`..coeffs.deis`, which the golden matrices check); the loop is a
Python loop with the eps history as a list, newest first.  As in the JAX
package, the AB samplers expose ``sampler.run(xT, *tables)`` with the
tables as arguments, ``sampler.run_args`` (the host tables) and
``sampler.structure``: the sweep's runner moves ``run_args`` to the card
once a cell and calls ``run``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..coeffs.deis import _lagrange_basis, ab_coefficients
from ..schedules import LinearVPSDE, deis_rev_ts


def _tensors(arrays, like):
    return [torch.as_tensor(np.asarray(a, np.float64)).to(
        dtype=like.dtype, device=like.device) for a in arrays]


def _ab_step(c, x, new_eps, hist):
    """``c0 x + c1 eps_new + sum_j c_{2+j} hist_j`` (the reference's
    ``ab_step``, ``deps/th_deis/multistep.py:98-104``)."""
    new_x = c[0] * x + c[1] * new_eps
    for j, e in enumerate(hist):
        new_x = new_x + c[2 + j] * e
    return new_x


def _ab_scan(eps_fn: Callable, rev_ts: np.ndarray, ab_coef: np.ndarray,
             order: int):
    """The shared AB loop (``sampler.py:37-48``): the history is seeded
    with xT."""
    @torch.no_grad()
    def run(xT, ts, coefs):
        x, hist = xT, [xT] * order
        for i in range(ts.shape[0]):
            new_eps = eps_fn(x, ts[i])
            x = _ab_step(coefs[i], x, new_eps, hist)
            hist = [new_eps] + hist[:-1]
        return x

    def sampler(xT):
        return run(xT, *_tensors(run_args, xT))

    run_args = (np.asarray(rev_ts[:-1]), np.asarray(ab_coef))
    sampler.run = run
    sampler.run_args = run_args
    sampler.structure = ("ab_scan", order)
    return sampler


def get_sampler_t_ab(sde: LinearVPSDE, eps_fn: Callable, ts_phase: str,
                     ts_order: float, num_step: int, ab_order: int = 3,
                     t0: float = 1e-3):
    """t-AB: exponential integrator in t with the psi transition
    (``sampler.py:26-48``)."""
    rev_ts = deis_rev_ts(sde, num_step, ts_order, ts_phase, t0=t0)
    x_coef = np.sqrt(sde.t2alpha(rev_ts[1:]) / sde.t2alpha(rev_ts[:-1]))
    eps_coef = ab_coefficients(sde, ab_order, rev_ts, ab_order)
    ab_coef = np.concatenate([x_coef[:, None], eps_coef], axis=1)
    return _ab_scan(eps_fn, rev_ts, ab_coef, ab_order)


def get_sampler_ipndm(sde: LinearVPSDE, eps_fn: Callable, num_step: int,
                      t0: float = 1e-3):
    """iPNDM: the classical linear-multistep AB weights scaled by the DDIM
    eps coefficient (``sampler.py:50-95``)."""
    rev_ts = deis_rev_ts(sde, num_step, 1.0, "t", t0=t0)
    x_coef = np.sqrt(sde.t2alpha(rev_ts[1:]) / sde.t2alpha(rev_ts[:-1]))

    lin = np.zeros((num_step, 4))
    for i in range(num_step):
        if i == 0:
            lin[i] = [1.0, 0, 0, 0]
        elif i == 1:
            lin[i] = [1.5, -0.5, 0, 0]
        elif i == 2:
            lin[i] = np.array([23.0, -16.0, 5.0, 0.0]) / 12.0
        else:
            lin[i] = np.array([55.0, -59.0, 37.0, -9.0]) / 24.0

    next_a = sde.t2alpha(rev_ts[1:])
    cur_a = sde.t2alpha(rev_ts[:-1])
    ddim_coef = np.sqrt(1 - next_a) - np.sqrt(next_a / cur_a) * np.sqrt(1 - cur_a)
    eps_coef = ddim_coef[:, None] * lin
    ab_coef = np.concatenate([x_coef[:, None], eps_coef], axis=1)
    return _ab_scan(eps_fn, rev_ts, ab_coef, 3)


def get_sampler_rho_ab(sde: LinearVPSDE, eps_fn: Callable, ts_phase: str,
                       ts_order: float, num_step: int, ab_order: int = 3,
                       t0: float = 1e-3):
    """rho-AB: plain polynomial AB in the rho parameterisation (psi == 1
    and integrand == 1), so the quadrature reduces to Lagrange-basis
    integrals (``sampler.py:98-134``)."""
    rev_ts = deis_rev_ts(sde, num_step, ts_order, ts_phase, t0=t0)
    rev_rhos = sde.t2rho(rev_ts)

    n = num_step
    eps_coef = np.zeros((n, ab_order + 1))
    for i in range(n):
        k = min(i, ab_order)
        ts_poly = rev_rhos[i - k: i + 1]
        # integral of each Lagrange basis over [rho_i, rho_{i+1}] (a
        # 10k-point left-Riemann sum, the reference's grid)
        m = 10000
        dr = (rev_rhos[i + 1] - rev_rhos[i]) / m
        tau = rev_rhos[i] + np.arange(m) * dr
        basis = _lagrange_basis(tau, ts_poly)
        eps_coef[i, : k + 1] = (basis.sum(axis=0) * dr)[::-1]
    ab_coef = np.concatenate([np.ones((n, 1)), eps_coef], axis=1)
    alpha_ts = sde.t2alpha(rev_ts)

    @torch.no_grad()
    def run(xT, ts, sas, coefs, sa_ends):
        # per step eps at x = v sqrt(alpha_{t_i}), t = rev_ts[i]; sa_ends =
        # [sqrt(alpha_{t_N}), sqrt(alpha_{t_0})]
        v, hist = xT / sa_ends[0], [xT] * ab_order
        for i in range(ts.shape[0]):
            new_eps = eps_fn(v * sas[i], ts[i])
            v = _ab_step(coefs[i], v, new_eps, hist)
            hist = [new_eps] + hist[:-1]
        return v * sa_ends[1]

    def sampler(xT):
        return run(xT, *_tensors(run_args, xT))

    run_args = (np.asarray(rev_ts[:-1]), np.sqrt(alpha_ts[:-1]),
                np.asarray(ab_coef),
                np.sqrt(np.asarray([alpha_ts[0], alpha_ts[-1]])))
    sampler.run = run
    sampler.run_args = run_args
    sampler.structure = ("rho_ab", ab_order)
    return sampler


# -- rho-RK (reference rk.py:3-85) --------------------------------------------

_RK_TABLEAUS = {
    "1euler": ([], [1.0], [0.0]),
    "2heun": ([[1.0]], [0.5, 0.5], [0.0, 1.0]),
    "3kutta": ([[0.5], [-1.0, 2.0]], [1 / 6, 4 / 6, 1 / 6], [0.0, 0.5, 1.0]),
    "3ral": ([[0.5], [0.0, 0.75]], [2 / 9, 1 / 3, 4 / 9], [0.0, 0.5, 0.75]),
    "3heun": ([[1 / 3], [0.0, 2 / 3]], [0.25, 0.0, 0.75], [0.0, 1 / 3, 2 / 3]),
    "3vdh": ([[8 / 15], [0.25, 5 / 12]], [0.25, 0.0, 0.75],
             [0.0, 8 / 15, 2 / 3]),
    "3ssprk": ([[1.0], [0.25, 0.25]], [1 / 6, 1 / 6, 2 / 3], [0.0, 1.0, 0.5]),
    "4rk": ([[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
            [1 / 6, 2 / 6, 2 / 6, 1 / 6], [0.0, 0.5, 0.5, 1.0]),
}


def get_sampler_rho_rk(sde: LinearVPSDE, eps_fn: Callable, ts_phase: str,
                       ts_order: float, num_step: int,
                       rk_method: str = "3kutta", t0: float = 1e-3):
    """rho-RK: explicit Runge-Kutta on dv/drho = eps (``sampler.py:
    137-160``).  Each stage's time and sqrt(alpha) are host numbers known
    before the loop, so they go to the device once, as two tables."""
    a_tab, b_tab, c_tab = _RK_TABLEAUS[rk_method]
    rev_ts = deis_rev_ts(sde, num_step, ts_order, ts_phase, t0=t0)
    rev_rhos = sde.t2rho(rev_ts)
    dr = rev_rhos[1:] - rev_rhos[:-1]
    stage_t = np.stack([sde.rho2t(rev_rhos[:-1] + c * dr) for c in c_tab], 1)
    stage_sa = np.sqrt(sde.t2alpha(stage_t))

    @torch.no_grad()
    def sampler(xT):
        ts, sas = _tensors((stage_t, stage_sa), xT)
        v = xT / float(np.sqrt(sde.t2alpha(rev_ts[0])))
        for i in range(num_step):
            ks = []
            for j, row in enumerate([[]] + a_tab):
                vi = v
                for aij, kj in zip(row, ks):
                    vi = vi + float(dr[i]) * aij * kj
                ks.append(eps_fn(vi * sas[i, j], ts[i, j]))
            for b, k in zip(b_tab, ks):
                v = v + float(dr[i]) * b * k
        return v * float(np.sqrt(sde.t2alpha(rev_ts[-1])))

    return sampler


def get_sampler(sde: LinearVPSDE, eps_fn: Callable, ts_phase: str,
                ts_order: float, num_step: int, method: str = "rho_rk",
                ab_order: int = 3, rk_method: str = "3kutta",
                t0: float = 1e-3):
    """The entry point of ``deps/th_deis/sampler.py:15-24``."""
    method = method.lower()
    if method == "rho_rk":
        return get_sampler_rho_rk(sde, eps_fn, ts_phase, ts_order, num_step,
                                  rk_method, t0=t0)
    if method == "rho_ab":
        return get_sampler_rho_ab(sde, eps_fn, ts_phase, ts_order, num_step,
                                  ab_order, t0=t0)
    if method == "t_ab":
        return get_sampler_t_ab(sde, eps_fn, ts_phase, ts_order, num_step,
                                ab_order, t0=t0)
    if method == "ipndm":
        return get_sampler_ipndm(sde, eps_fn, num_step, t0=t0)
    raise ValueError(method)
