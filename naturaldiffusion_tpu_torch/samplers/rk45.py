"""Adaptive RK45 (Dormand-Prince 5(4)) as a host loop (port of
``naturaldiffusion_tpu/samplers/rk45.py``, itself the on-device form of
the reference's ``scipy.integrate.solve_ivp(..., method='RK45')``).

The same tableau, error norm (RMS over all elements, scipy's convention)
and step controller (order 5, safety 0.9, factors [0.2, 10]) as the JAX
package's ``lax.while_loop``.  The state stays on its device; the time and
the step size are float64 host scalars, and each step reads its error norm
from the device once, to accept or reject it.  JAX keeps the time in the
state's type: in float32 a step clamped to end at t1 can land one ulp past
it, where ``|t1 - t| > 1e-12`` holds and the fixed direction walks away
from t1 (to negative times and NaN); in float64 it lands within 1e-12.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Dormand-Prince coefficients
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)

_SAFETY, _MIN_FACTOR, _MAX_FACTOR, _ORDER = 0.9, 0.2, 10.0, 5.0
_MAX_STEPS = 10_000


def rk45_integrate(f, y0, t0: float, t1: float, *, rtol=1e-5, atol=1e-5):
    """Integrate dy/dt = f(y, t) from t0 to t1 (t1 < t0 supported).

    ``f(y, t)`` gets the state tensor and the time as a host scalar.
    Returns ``(y(t1), nfe)``, nfe counted as JAX counts it: 1 for the
    initial slope, 6 a step.  Here nfe is also the number of calls of
    ``f``: the seventh stage is evaluated at the step's result (Dormand-
    Prince's last row of A is its 5th-order weights), so it is the next
    step's first stage, and a rejected step keeps its first stage (JAX
    evaluates all 7 every step).  A non-finite error norm raises
    ``FloatingPointError`` (JAX's loop would reject steps until
    ``_MAX_STEPS``)."""
    direction = 1.0 if t1 >= t0 else -1.0
    t0, t1 = float(t0), float(t1)
    b_err = torch.tensor([p - q for p, q in zip(_B5, _B4)], dtype=y0.dtype,
                         device=y0.device)

    def rms(e):
        return torch.sqrt(torch.mean(e ** 2))

    def scaled_err(err, y_old, y_new):
        scale = atol + torch.maximum(y_old.abs(), y_new.abs()) * rtol
        return rms(err / scale)

    # initial step (scipy's _select_initial_step, simplified, as JAX)
    f0 = f(y0, t0)
    d0 = float(rms(y0 / (atol + y0.abs() * rtol)))
    d1 = float(rms(f0 / (atol + y0.abs() * rtol)))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    h0 = min(h0, abs(t1 - t0))

    def step_once(y, t, h, k1):
        ks = [k1]
        for i in range(1, 7):
            a = _A[i]
            dy = sum(a[j] * ks[j] for j in range(len(a)))
            y_i = y + h * dy
            ks.append(f(y_i, t + _C[i] * h))
        # the last stage's input is the 5th-order result, y + h B5 . k
        return y_i, ks[6], h * torch.tensordot(b_err, torch.stack(ks),
                                               dims=1)

    y, t, h, k1, nfe = y0, t0, direction * h0, f0, 1
    for _ in range(_MAX_STEPS):
        # clamp the step so it does not overshoot t1
        h_eff = direction * min(abs(h), abs(t1 - t))
        y_new, k_new, err = step_once(y, t, h_eff, k1)
        e = float(scaled_err(err, y, y_new))       # the device read
        if not math.isfinite(e):
            raise FloatingPointError(f"rk45: non-finite error norm at t = "
                                     f"{t} (step {h_eff})")
        factor = _MAX_FACTOR if e == 0.0 else float(np.clip(
            _SAFETY * e ** (-1.0 / _ORDER), _MIN_FACTOR, _MAX_FACTOR))
        h = direction * abs(h_eff) * factor
        nfe += 6
        if e <= 1.0:                               # accept
            y, t, k1 = y_new, t + h_eff, k_new
            if abs(t1 - t) <= 1e-12:
                break
    return y, nfe
