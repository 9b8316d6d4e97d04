"""Direct (non-NI) sampler recursions (port of
``naturaldiffusion_tpu/samplers/direct.py``).

The original algorithms that the coefficient matrices are derived from.
Natural Inference with the derived matrix must reproduce each of them from
the same seed (``src/ValidateNaturalInference.py:375-382``), and they run
the same float64 per-step coefficients as the matching deriver in
:mod:`..coeffs`, precomputed on the host from :mod:`..schedules`.

Every sampler takes ``x0_fn(x, t) -> predicted x0``, called with the state
in ``dtype`` and the step's time as a 0-d tensor of ``dtype`` on the
state's device, and returns the final state.  The loop is a Python loop
(the JAX package's ``lax.scan``); the coefficients multiply as host
floats.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..schedules import DiscreteVP, LinearVPSDE, flow_sigmas


@torch.no_grad()
def _run(step_fn, x_init, times, per_step, dtype):
    """``x <- step_fn(x, t_k, k, *coefficients_k)`` for each step k; the
    times go to the device once, as one tensor."""
    x = torch.as_tensor(x_init).to(dtype)
    ts = torch.as_tensor(np.array(times, np.float64)).to(
        dtype=dtype, device=x.device)
    cols = [[float(c) for c in np.asarray(col)] for col in per_step]
    for k in range(len(times)):
        x = step_fn(x, ts[k], k, *(col[k] for col in cols))
    return x


# ---------------------------------------------------------------------------
# Discrete DDPM / DDIM (reference: src/ValidateNaturalInference.py:207-308)
# ---------------------------------------------------------------------------


def ddpm_ancestral(x0_fn: Callable, num_step: int, init_noise, noises,
                   dtype=torch.float32):
    """DDPM ancestral skip-sampling; ``noises`` [num_step, ...] injected,
    one per step."""
    sch = DiscreteVP.create(num_step)
    noises = torch.as_tensor(noises).to(dtype)

    def step(x, t, k, cxt, cx0, s):
        y = x0_fn(x, t)
        return cxt * x + cx0 * y + s * noises[k]

    return _run(step, init_noise, sch.timesteps[::-1],
                (sch.ddpm_coeff_xt[::-1], sch.ddpm_coeff_x0[::-1],
                 sch.posterior_std[::-1]), dtype)


def ddim(x0_fn: Callable, num_step: int, init_noise, dtype=torch.float32):
    """DDIM (eta = 0) skip-sampling."""
    sch = DiscreteVP.create(num_step)

    def step(x, t, k, cxt, cx0):
        return cxt * x + cx0 * x0_fn(x, t)

    return _run(step, init_noise, sch.timesteps[::-1],
                (sch.ddim_coeff_xt[::-1], sch.ddim_coeff_x0[::-1]), dtype)


# ---------------------------------------------------------------------------
# Continuous VP-SDE Euler / Heun (reference: src/AnalyzeEulerHeun.py:50-292)
# ---------------------------------------------------------------------------


def _vp_grid(num_step: int):
    n = num_step + 1
    eta = 1.0 / n
    dt = (eta - 1.0) / (n - 1)
    return 1.0 + np.arange(n) * dt, dt


def ode_euler(x0_fn: Callable, num_step: int, init_noise,
              dtype=torch.float32):
    """Probability-flow ODE, explicit Euler, linear VP-SDE."""
    sde = LinearVPSDE()
    ts, dt = _vp_grid(num_step)
    s = ts[:-1]
    alpha, sigma = sde.marginal_coeff(s)

    def step(x, t, k, f_, g2_, a_, s_):
        y = x0_fn(x, t)
        score = (a_ * y - x) / s_ ** 2
        return x + (f_ * x - 0.5 * g2_ * score) * dt

    return _run(step, init_noise, s,
                (-0.5 * sde.beta(s), sde.beta(s), alpha, sigma), dtype)


def sde_euler(x0_fn: Callable, num_step: int, init_noise, noises,
              dtype=torch.float32):
    """Reverse SDE, Euler-Maruyama, linear VP-SDE."""
    sde = LinearVPSDE()
    ts, dt = _vp_grid(num_step)
    s = ts[:-1]
    g2 = sde.beta(s)
    alpha, sigma = sde.marginal_coeff(s)
    noises = torch.as_tensor(noises).to(dtype)

    def step(x, t, k, f_, g2_, a_, s_, ns_):
        y = x0_fn(x, t)
        score = (a_ * y - x) / s_ ** 2
        return x + (f_ * x - g2_ * score) * dt + ns_ * noises[k]

    return _run(step, init_noise, s,
                (-0.5 * g2, g2, alpha, sigma, np.sqrt(g2) * np.sqrt(abs(dt))),
                dtype)


def ode_heun(x0_fn: Callable, num_step: int, init_noise,
             dtype=torch.float32):
    """Heun's method on the probability-flow ODE, with the reference's
    exact discretization: alpha at s with sigma at t in the corrector stage
    (``src/AnalyzeEulerHeun.py:249``; see ``coeffs/euler_heun.py``)."""
    sde = LinearVPSDE()
    ts, dt = _vp_grid(num_step)
    s, t = ts[:-1], ts[1:]
    alpha_s, sigma_s = sde.marginal_coeff(s)
    _, sigma_t = sde.marginal_coeff(t)
    x = torch.as_tensor(init_noise).to(dtype)
    t_dev = torch.as_tensor(np.array(t, np.float64)).to(dtype=dtype,
                                                       device=x.device)

    def step(x, s_, k, fs_, g2s_, ft_, g2t_, as_, ss_, st_):
        y = x0_fn(x, s_)
        vel_s = fs_ * x - 0.5 * g2s_ * ((as_ * y - x) / ss_ ** 2)
        x_hat = x + vel_s * dt
        y_hat = x0_fn(x_hat, t_dev[k])
        vel_t = ft_ * x_hat - 0.5 * g2t_ * ((as_ * y_hat - x_hat) / st_ ** 2)
        return x + 0.5 * (vel_s + vel_t) * dt

    return _run(step, x, s,
                (-0.5 * sde.beta(s), sde.beta(s), -0.5 * sde.beta(t),
                 sde.beta(t), alpha_s, sigma_s, sigma_t), dtype)


# ---------------------------------------------------------------------------
# Rectified-flow Euler (reference: src/AnalyzeFlowMatching.py / SD3 loop)
# ---------------------------------------------------------------------------


def flow_euler(x0_fn: Callable, num_step: int, init_noise,
               dtype=torch.float32):
    """Flow-matching Euler: x_t = x_s + (x_s - x0) / s * (t - s), s from 1
    to 0."""
    sig = flow_sigmas(num_step)[::-1]
    s, t = sig[:-1], sig[1:]

    def step(x, s_t, k, s_, t_):
        y = x0_fn(x, s_t)
        return x + (x - y) / s_ * (t_ - s_)

    return _run(step, init_noise, s, (s, t), dtype)
