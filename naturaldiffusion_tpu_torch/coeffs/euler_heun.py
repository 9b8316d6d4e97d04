"""SDE Euler-Maruyama, probability-flow ODE Euler, and Heun coefficient
matrices for the continuous linear VP-SDE.

Copy of ``naturaldiffusion_tpu/coeffs/euler_heun.py`` (numpy only), kept here so the
port never imports the JAX package.

Affine replay of the discretized reverse SDE/ODE (reference:
``src/AnalyzeEulerHeun.py:50-292``).  Regression oracles:
``results/euler_heun/{sde_euler,ode_euler,ode_heun}_*.npz``.

Time grid convention (reference ``:56-59``): N = num_step+1 nodes from 1 down
to eta = 1/N, uniform spacing dt = (eta-1)/(N-1).
"""

from __future__ import annotations

import numpy as np

from ..affine import AffineTracker
from ..schedules import LinearVPSDE
from .assemble import Node, assemble
from .matrix import CoeffMatrix

_KEY = "%0.4f"


def _time_grid(num_step: int) -> tuple[np.ndarray, float]:
    n = num_step + 1
    eta = 1.0 / n
    dt = (eta - 1.0) / (n - 1)
    return 1.0 + np.arange(n) * dt, dt


def _score(sde: LinearVPSDE, x, y, t: float):
    """Affine score from predicted x0: (alpha_t y - x) / sigma_t^2."""
    alpha, sigma = sde.marginal_coeff(t)
    return (alpha * y - x) / sigma ** 2


def _vp_nodes(sde: LinearVPSDE, times: list[float]) -> list[Node]:
    out = []
    for t in times:
        alpha, sigma = sde.marginal_coeff(t)
        out.append(Node(t=float(t), key=_KEY % t, alpha=float(alpha), sigma=float(sigma)))
    return out


def derive_ode_euler(num_step: int) -> CoeffMatrix:
    """Probability-flow ODE, explicit Euler (``analyze_ode``, ``:50-122``)."""
    sde = LinearVPSDE()
    ts, dt = _time_grid(num_step)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    for i in range(num_step):
        s, t = ts[i], ts[i + 1]
        x_s = tr.get_item(f"x_{_KEY % s}")
        y_s = tr.new_y(_KEY % s)
        f, g = sde.sde_coeff(s)
        velocity = f * x_s - 0.5 * g ** 2 * _score(sde, x_s, y_s, s)
        tr.add_item(f"x_{_KEY % t}", x_s + velocity * dt)
        tr.new_eps(_KEY % t)  # deterministic: zero-coefficient column pad

    return assemble(tr, _vp_nodes(sde, list(ts)))


def derive_sde_euler(num_step: int) -> CoeffMatrix:
    """Reverse SDE, Euler-Maruyama (``analyze_sde``, ``:125-200``)."""
    sde = LinearVPSDE()
    ts, dt = _time_grid(num_step)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    for i in range(num_step):
        s, t = ts[i], ts[i + 1]
        x_s = tr.get_item(f"x_{_KEY % s}")
        y_s = tr.new_y(_KEY % s)
        f, g = sde.sde_coeff(s)
        velocity = f * x_s - g ** 2 * _score(sde, x_s, y_s, s)
        noise_scale = g * np.sqrt(abs(dt))
        x_t = x_s + velocity * dt + noise_scale * tr.new_eps(_KEY % t)
        tr.add_item(f"x_{_KEY % t}", x_t)

    return assemble(tr, _vp_nodes(sde, list(ts)))


def derive_ode_heun(num_step: int, offset: float = 0.0005) -> CoeffMatrix:
    """Heun's 2nd-order method on the probability-flow ODE
    (``analyze_heun``, ``:203-292``).

    Heun makes two denoiser predictions per interval, so there are
    ``2*num_step`` matrix rows; the intermediate (predictor) state is keyed at
    ``t + offset`` to disambiguate it from the corrected state at ``t``
    (reference ``:240-242``).

    Note: the reference's corrector stage scales the second prediction with
    the marginal *alpha at s* rather than at t (``:249``,
    ``score_t = (y_coeff_s*y_t_hat - x_t_hat)/noise_coeff_t**2``).  We
    reproduce that exact discretization — it is what the golden corpus and the
    validated sampler execute.
    """
    sde = LinearVPSDE()
    ts, dt = _time_grid(num_step)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    times = [ts[0]]
    for i in range(num_step):
        s, t = ts[i], ts[i + 1]
        x_s = tr.get_item(f"x_{_KEY % s}")

        # predictor (Euler) step
        y_s = tr.new_y(_KEY % s)
        f_s, g_s = sde.sde_coeff(s)
        alpha_s, sigma_s = sde.marginal_coeff(s)
        vel_s = f_s * x_s - 0.5 * g_s ** 2 * ((alpha_s * y_s - x_s) / sigma_s ** 2)
        x_hat = x_s + vel_s * dt
        tr.add_item(f"x_{_KEY % (t + offset)}", x_hat)
        times.append(t + offset)

        # corrector step (second prediction at the intermediate state)
        y_hat = tr.new_y(_KEY % (t + offset))
        _, sigma_t = sde.marginal_coeff(t)
        f_t, g_t = sde.sde_coeff(t)
        vel_t = f_t * x_hat - 0.5 * g_t ** 2 * ((alpha_s * y_hat - x_hat) / sigma_t ** 2)
        x_t = x_s + 0.5 * (vel_s + vel_t) * dt
        tr.add_item(f"x_{_KEY % t}", x_t)
        times.append(t)

        tr.new_eps(_KEY % (t + offset))
        tr.new_eps(_KEY % t)

    times = sorted(set(times), reverse=True)
    return assemble(tr, _vp_nodes(sde, times))
