"""Singlestep DPM-Solver-2/-3 and DPM-Solver++-2/-3 coefficient matrices.

Copy of ``naturaldiffusion_tpu/coeffs/dpm_solver.py`` (numpy only), kept here so the
port never imports the JAX package.

Affine replay of the lambda-space exponential-integrator updates for the
continuous linear VP schedule (reference: ``src/AnalyzeDPMSolver.py:228-666``,
which itself mirrors ``deps/dpm_solver_pytorch.py``).  Regression oracles:
``results/dpmsolver/dpmsolver{2s,3s}_*.npz`` and
``results/dpmsolverpp/dpmsolverpp{2s,3s}_*.npz``.

Each outer step spans ``[s, t]`` on a uniform grid ``linspace(1.0, 0.001,
step+1)`` and inserts intermediate nodes ``s_i = inverse_lambda(lambda_s +
r_i h)``, so a 2s run with ``step`` outer steps yields ``2*step`` matrix rows
and a 3s run ``3*step`` (the non-uniform node bookkeeping the survey flags at
SURVEY.md §7 'hard parts').
"""

from __future__ import annotations

import numpy as np

from ..affine import AffineTracker
from ..schedules import LinearVPSDE
from .assemble import Node, assemble
from .matrix import CoeffMatrix

_KEY = "%0.4f"


def _vp_nodes(sde: LinearVPSDE, times) -> list[Node]:
    out = []
    for t in times:
        alpha, sigma = sde.marginal_coeff(t)
        out.append(Node(t=float(t), key=_KEY % t, alpha=float(alpha), sigma=float(sigma)))
    return out


def _finish(tr: AffineTracker, sde: LinearVPSDE, all_times: list[float],
            expected_rows: int) -> CoeffMatrix:
    times = sorted(np.unique(np.array(all_times)), reverse=True)
    assert len(times) == expected_rows + 1, (len(times), expected_rows)
    # deterministic solvers: pad zero-coefficient eps columns for every
    # non-start node (only the initial-noise column is populated)
    for t in times[1:]:
        tr.new_eps(_KEY % t)
    return assemble(tr, _vp_nodes(sde, times))


def derive_dpmsolver_2s(step: int) -> CoeffMatrix:
    """Singlestep DPM-Solver-2 (eps-prediction form), r1 = 1/2."""
    sde = LinearVPSDE()
    ts = np.linspace(1.0, 0.001, step + 1)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    all_times: list[float] = []
    for i in range(step):
        s, t = ts[i], ts[i + 1]
        r1 = 0.5
        lam_s, lam_t = sde.lam(s), sde.lam(t)
        h = lam_t - lam_s
        s1 = sde.inverse_lam(lam_s + r1 * h)
        all_times += [s, float(s1), t]

        la_s, la_s1, la_t = sde.log_alpha(s), sde.log_alpha(s1), sde.log_alpha(t)
        sig_s, sig_s1, sig_t = sde.sigma(s), sde.sigma(s1), sde.sigma(t)
        alpha_s, alpha_s1 = np.exp(la_s), np.exp(la_s1)

        x_s = tr.get_item(f"x_{_KEY % s}")

        # predictor to the lambda-midpoint
        y_s = tr.new_y(_KEY % s)
        model_s = (x_s - alpha_s * y_s) / sig_s          # eps from predicted x0
        x_s1 = (np.exp(la_s1 - la_s) * x_s
                - sig_s1 * np.expm1(r1 * h) * model_s)
        tr.add_item(f"x_{_KEY % s1}", x_s1)

        # corrected full step
        y_s1 = tr.new_y(_KEY % s1)
        model_s1 = (x_s1 - alpha_s1 * y_s1) / sig_s1
        phi = np.expm1(h)
        x_t = (np.exp(la_t - la_s) * x_s
               - sig_t * phi * model_s
               - (0.5 / r1) * sig_t * phi * (model_s1 - model_s))
        tr.add_item(f"x_{_KEY % t}", x_t)

    return _finish(tr, sde, all_times, 2 * step)


def derive_dpmsolver_pp_2s(step: int) -> CoeffMatrix:
    """Singlestep DPM-Solver++(2S) (data-prediction form), r1 = 1/2."""
    sde = LinearVPSDE()
    ts = np.linspace(1.0, 0.001, step + 1)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    all_times: list[float] = []
    for i in range(step):
        s, t = ts[i], ts[i + 1]
        r1 = 0.5
        lam_s, lam_t = sde.lam(s), sde.lam(t)
        h = lam_t - lam_s
        s1 = sde.inverse_lam(lam_s + r1 * h)
        all_times += [s, float(s1), t]

        sig_s, sig_s1, sig_t = sde.sigma(s), sde.sigma(s1), sde.sigma(t)
        alpha_s1, alpha_t = sde.alpha(s1), sde.alpha(t)

        x_s = tr.get_item(f"x_{_KEY % s}")

        # ++ works directly on predicted x0
        model_s = tr.new_y(_KEY % s)
        x_s1 = (sig_s1 / sig_s) * x_s - alpha_s1 * np.expm1(-r1 * h) * model_s
        tr.add_item(f"x_{_KEY % s1}", x_s1)

        model_s1 = tr.new_y(_KEY % s1)
        phi = np.expm1(-h)
        x_t = ((sig_t / sig_s) * x_s
               - alpha_t * phi * model_s
               - (0.5 / r1) * alpha_t * phi * (model_s1 - model_s))
        tr.add_item(f"x_{_KEY % t}", x_t)

    return _finish(tr, sde, all_times, 2 * step)


def derive_dpmsolver_3s(step: int) -> CoeffMatrix:
    """Singlestep DPM-Solver-3, r1 = 1/3, r2 = 2/3."""
    sde = LinearVPSDE()
    ts = np.linspace(1.0, 0.001, step + 1)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    all_times: list[float] = []
    for i in range(step):
        s, t = ts[i], ts[i + 1]
        r1, r2 = 1.0 / 3.0, 2.0 / 3.0
        lam_s, lam_t = sde.lam(s), sde.lam(t)
        h = lam_t - lam_s
        s1 = sde.inverse_lam(lam_s + r1 * h)
        s2 = sde.inverse_lam(lam_s + r2 * h)
        all_times += [s, float(s1), float(s2), t]

        la_s, la_s1 = sde.log_alpha(s), sde.log_alpha(s1)
        la_s2, la_t = sde.log_alpha(s2), sde.log_alpha(t)
        sig_s, sig_s1, sig_s2, sig_t = (sde.sigma(s), sde.sigma(s1),
                                        sde.sigma(s2), sde.sigma(t))
        alpha_s, alpha_s1, alpha_s2 = np.exp(la_s), np.exp(la_s1), np.exp(la_s2)

        x_s = tr.get_item(f"x_{_KEY % s}")

        y_s = tr.new_y(_KEY % s)
        model_s = (x_s - alpha_s * y_s) / sig_s
        x_s1 = (np.exp(la_s1 - la_s) * x_s
                - sig_s1 * np.expm1(r1 * h) * model_s)
        tr.add_item(f"x_{_KEY % s1}", x_s1)

        y_s1 = tr.new_y(_KEY % s1)
        model_s1 = (x_s1 - alpha_s1 * y_s1) / sig_s1
        phi2 = np.expm1(r2 * h)
        phi2d = np.expm1(r2 * h) / (r2 * h) - 1.0
        x_s2 = (np.exp(la_s2 - la_s) * x_s
                - sig_s2 * phi2 * model_s
                - (r2 / r1) * sig_s2 * phi2d * (model_s1 - model_s))
        tr.add_item(f"x_{_KEY % s2}", x_s2)

        y_s2 = tr.new_y(_KEY % s2)
        model_s2 = (x_s2 - alpha_s2 * y_s2) / sig_s2
        phi = np.expm1(h)
        phid = phi / h - 1.0
        x_t = (np.exp(la_t - la_s) * x_s
               - sig_t * phi * model_s
               - (1.0 / r2) * sig_t * phid * (model_s2 - model_s))
        tr.add_item(f"x_{_KEY % t}", x_t)

    return _finish(tr, sde, all_times, 3 * step)


def derive_dpmsolver_pp_3s(step: int) -> CoeffMatrix:
    """Singlestep DPM-Solver++(3S), r1 = 1/3, r2 = 2/3."""
    sde = LinearVPSDE()
    ts = np.linspace(1.0, 0.001, step + 1)

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    all_times: list[float] = []
    for i in range(step):
        s, t = ts[i], ts[i + 1]
        r1, r2 = 1.0 / 3.0, 2.0 / 3.0
        lam_s, lam_t = sde.lam(s), sde.lam(t)
        h = lam_t - lam_s
        s1 = sde.inverse_lam(lam_s + r1 * h)
        s2 = sde.inverse_lam(lam_s + r2 * h)
        all_times += [s, float(s1), float(s2), t]

        sig_s, sig_s1, sig_s2, sig_t = (sde.sigma(s), sde.sigma(s1),
                                        sde.sigma(s2), sde.sigma(t))
        alpha_s1, alpha_s2, alpha_t = sde.alpha(s1), sde.alpha(s2), sde.alpha(t)

        x_s = tr.get_item(f"x_{_KEY % s}")

        model_s = tr.new_y(_KEY % s)
        x_s1 = (sig_s1 / sig_s) * x_s - alpha_s1 * np.expm1(-r1 * h) * model_s
        tr.add_item(f"x_{_KEY % s1}", x_s1)

        model_s1 = tr.new_y(_KEY % s1)
        phi2 = np.expm1(-r2 * h)
        phi2d = np.expm1(-r2 * h) / (r2 * h) + 1.0
        x_s2 = ((sig_s2 / sig_s) * x_s
                - alpha_s2 * phi2 * model_s
                - (r2 / r1) * alpha_s2 * phi2d * (model_s1 - model_s))
        tr.add_item(f"x_{_KEY % s2}", x_s2)

        model_s2 = tr.new_y(_KEY % s2)
        phi = np.expm1(-h)
        phid = phi / h + 1.0
        x_t = ((sig_t / sig_s) * x_s
               - alpha_t * phi * model_s
               - (1.0 / r2) * alpha_t * phid * (model_s2 - model_s))
        tr.add_item(f"x_{_KEY % t}", x_t)

    return _finish(tr, sde, all_times, 3 * step)
