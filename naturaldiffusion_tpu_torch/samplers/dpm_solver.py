"""DPM-Solver / DPM-Solver++ (port of ``naturaldiffusion_tpu/samplers/
dpm_solver.py``, itself a rebuild of ``deps/dpm_solver_pytorch.py:6-1305``).

``NoiseScheduleVP`` (linear, cosine, discrete), the 4 x 3 model/guidance
wrapper taxonomy, singlestep orders 1-3 (``dpmsolver`` and ``taylor``),
multistep orders 1-3 with lower-order warm-up and ``lower_order_final``,
the fixed singlestep plan, the adaptive DPM-Solver-12/23, dynamic
thresholding, ``denoise_to_zero`` and ``inverse``.

Times passed between the solver's updates are host scalars (the JAX
package's Python floats), so each update's coefficients are host floats
computed in float64 (in float32 in ``adaptive``, whose step control JAX
runs in float32) and multiply the state as scalars; the model gets the
time as a ``[B]`` tensor of the state's type.  ``NoiseScheduleVP``'s
methods take either a tensor (computed in its type, on its device) or a
host scalar or numpy array (computed in numpy).  The adaptive solver is a
host loop that reads its error norm once a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def _bc(a, x):
    """A per-sample ``[B]`` (or 0-d) tensor in x's type, broadcast over x's
    trailing dims."""
    a = a.to(x.dtype)
    return a.reshape(a.shape + (1,) * (x.dim() - a.dim()))


def _interp(x, xp, fp):
    """``np.interp`` in torch: piecewise-linear through (xp, fp), xp
    ascending, clamped to the end values outside."""
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    out = f0 + (x - x0) * (f1 - f0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1],
                                                      out))


def _xp(t):
    return torch if isinstance(t, torch.Tensor) else np


def _logaddexp0(v):
    """log(exp(v) + 1)."""
    if isinstance(v, torch.Tensor):
        return torch.logaddexp(v, torch.zeros_like(v))
    return np.logaddexp(v, 0.0)


@dataclasses.dataclass(frozen=True)
class NoiseScheduleVP:
    """The lambda = log(alpha) - log(sigma) machinery (reference
    ``deps/dpm_solver_pytorch.py:6-167``).

    ``schedule``: ``"linear"`` / ``"cosine"`` (continuous closed forms) or
    ``"discrete"`` (piecewise-linear interpolation of a trained log-alpha
    table, built by :meth:`discrete`)."""

    schedule: str = "linear"
    beta_0: float = 0.1
    beta_1: float = 20.0
    cosine_s: float = 0.008            # cosine-schedule shift
    # discrete mode tables (ascending t in [1/N, 1])
    t_array: tuple = ()
    log_alpha_array: tuple = ()
    total_N: int = 1000
    T: float = 1.0

    def __post_init__(self):
        if self.schedule == "cosine":
            # the cosine schedule saturates; cap T as the reference does
            object.__setattr__(self, "T", 0.9946)

    @classmethod
    def discrete(cls, betas=None, alphas_cumprod=None) -> "NoiseScheduleVP":
        if alphas_cumprod is None:
            alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, np.float64))
        log_alphas = 0.5 * np.log(alphas_cumprod)
        n = len(log_alphas)
        t_array = np.linspace(1.0 / n, 1.0, n)
        return cls(schedule="discrete", t_array=tuple(t_array),
                   log_alpha_array=tuple(log_alphas), total_N=n, T=1.0)

    def _cos_log_a0(self):
        s = self.cosine_s
        return math.log(math.cos(s / (1.0 + s) * math.pi / 2.0))

    def marginal_log_mean_coeff(self, t):
        xp = _xp(t)
        if self.schedule == "linear":
            return (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                    - 0.5 * t * self.beta_0)
        if self.schedule == "cosine":
            s = self.cosine_s
            return xp.log(xp.cos((t + s) / (1.0 + s) * math.pi / 2.0)) \
                - self._cos_log_a0()
        if xp is torch:
            return _interp(t, self.t_array, self.log_alpha_array)
        return np.interp(t, np.asarray(self.t_array),
                         np.asarray(self.log_alpha_array))

    def marginal_alpha(self, t):
        return _xp(t).exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        xp = _xp(t)
        return xp.sqrt(1.0 - xp.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        xp = _xp(t)
        la = self.marginal_log_mean_coeff(t)
        return la - 0.5 * xp.log(1.0 - xp.exp(2.0 * la))

    def inverse_lambda(self, lam):
        xp = _xp(lam)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * _logaddexp0(-2.0 * lam)
            delta = self.beta_0 ** 2 + tmp
            return tmp / (xp.sqrt(delta) + self.beta_0) \
                / (self.beta_1 - self.beta_0)
        if self.schedule == "cosine":
            s = self.cosine_s
            # lambda -> log_alpha: la = -0.5 * log(exp(-2 lam) + 1)
            la = -0.5 * _logaddexp0(-2.0 * lam)
            return (xp.arccos(xp.exp(la + self._cos_log_a0()))
                    * 2.0 * (1.0 + s) / math.pi - s)
        # discrete: t as a function of lambda (lambda falls as t rises)
        la = np.asarray(self.log_alpha_array)
        lams = (la - 0.5 * np.log(1.0 - np.exp(2.0 * la)))[::-1].copy()
        ts = np.asarray(self.t_array)[::-1].copy()
        if xp is torch:
            return _interp(lam, lams, ts)
        return np.interp(lam, lams, ts)

    # the JAX package's numpy twins, for host-side grid planning
    def marginal_lambda_np(self, t):
        return self.marginal_lambda(np.asarray(t, np.float64))

    def inverse_lambda_np(self, lam):
        return self.inverse_lambda(np.asarray(lam, np.float64))


# -- model wrappers (reference :170-335) --------------------------------------


def _cat_tree(a, b):
    """Concatenate two conditions along the batch: tensors, or dicts,
    lists and tuples of them."""
    if isinstance(a, dict):
        return {k: _cat_tree(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_cat_tree(u, v) for u, v in zip(a, b))
    return torch.cat([a, b], dim=0)


def model_wrapper(model: Callable, ns: NoiseScheduleVP, *,
                  model_type: str = "noise", model_kwargs: dict | None = None,
                  guidance_type: str = "uncond", condition=None,
                  unconditional_condition=None, guidance_scale: float = 1.0,
                  classifier_fn: Callable | None = None,
                  classifier_kwargs: dict | None = None) -> Callable:
    """Wrap any of 4 model parameterisations x 3 guidance types into the
    noise-prediction function ``(x, t_continuous [B]) -> eps`` the solver
    needs.  ``"classifier"`` guidance differentiates ``classifier_fn``'s
    summed log-probability with autograd."""
    model_kwargs = model_kwargs or {}
    classifier_kwargs = classifier_kwargs or {}

    def get_model_input_time(t_continuous):
        if ns.schedule == "discrete":
            return (t_continuous - 1.0 / ns.total_N) * 1000.0
        return t_continuous

    def noise_pred_fn(x, t_continuous, cond=None):
        t_input = get_model_input_time(t_continuous)
        out = model(x, t_input, **model_kwargs) if cond is None \
            else model(x, t_input, cond, **model_kwargs)
        if model_type == "noise":
            return out
        if model_type == "x_start":
            alpha_t = ns.marginal_alpha(t_continuous)
            sigma_t = ns.marginal_std(t_continuous)
            return (x - _bc(alpha_t, x) * out) / _bc(sigma_t, x)
        if model_type == "v":
            alpha_t = ns.marginal_alpha(t_continuous)
            sigma_t = ns.marginal_std(t_continuous)
            return _bc(alpha_t, x) * out + _bc(sigma_t, x) * x
        if model_type == "score":
            sigma_t = ns.marginal_std(t_continuous)
            return -_bc(sigma_t, x) * out
        raise ValueError(model_type)

    if guidance_type == "uncond":
        def model_fn(x, t):
            return noise_pred_fn(x, t)
    elif guidance_type == "classifier":
        if classifier_fn is None:
            raise ValueError("classifier guidance needs classifier_fn")

        def model_fn(x, t):
            t_input = get_model_input_time(t)
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                log_prob = classifier_fn(xg, t_input, condition,
                                         **classifier_kwargs).sum()
                grad, = torch.autograd.grad(log_prob, xg)
            sigma_t = ns.marginal_std(t)
            noise = noise_pred_fn(x, t)
            return noise - guidance_scale * _bc(sigma_t, x) * grad
    elif guidance_type == "classifier-free":
        def model_fn(x, t):
            if guidance_scale == 1.0 or unconditional_condition is None:
                return noise_pred_fn(x, t, cond=condition)
            x2 = torch.cat([x, x], dim=0)
            t2 = torch.cat([t, t]) if t.dim() else t
            c2 = _cat_tree(unconditional_condition, condition)
            noise_uncond, noise = torch.chunk(
                noise_pred_fn(x2, t2, cond=c2), 2, dim=0)
            return noise_uncond + guidance_scale * (noise - noise_uncond)
    else:
        raise ValueError(guidance_type)

    return model_fn


def dynamic_thresholding(x0, *, ratio: float = 0.995, max_val: float = 1.0):
    """Imagen dynamic thresholding (reference ``:416-426``)."""
    flat = x0.abs().reshape(x0.shape[0], -1)
    if flat.dtype not in (torch.float32, torch.float64):
        flat = flat.float()             # torch.quantile's types
    s = torch.quantile(flat, ratio, dim=1)
    s = torch.clamp(s, min=max_val).to(x0.dtype).reshape(
        (-1,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


# -- the solver ---------------------------------------------------------------


class DPMSolver:
    """The reference's ``DPM_Solver`` (``deps/dpm_solver_pytorch.py:
    337-1251``)."""

    def __init__(self, model_fn: Callable, ns: NoiseScheduleVP, *,
                 algorithm_type: str = "dpmsolver++",
                 correcting_x0_fn: Callable | str | None = None,
                 thresholding_max_val: float = 1.0,
                 dynamic_thresholding_ratio: float = 0.995):
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(algorithm_type)
        self.model = model_fn
        self.ns = ns
        self.algorithm_type = algorithm_type
        if correcting_x0_fn == "dynamic_thresholding":
            self.correcting_x0_fn = lambda x0, t: dynamic_thresholding(
                x0, ratio=dynamic_thresholding_ratio,
                max_val=thresholding_max_val)
        else:
            self.correcting_x0_fn = correcting_x0_fn

    # prediction forms -------------------------------------------------------

    def noise_prediction_fn(self, x, t):
        return self.model(x, t)

    def data_prediction_fn(self, x, t):
        noise = self.noise_prediction_fn(x, t)
        alpha_t = self.ns.marginal_alpha(t)
        sigma_t = self.ns.marginal_std(t)
        x0 = (x - _bc(sigma_t, x) * noise) / _bc(alpha_t, x)
        if self.correcting_x0_fn is not None:
            x0 = self.correcting_x0_fn(x0, t)
        return x0

    def model_fn(self, x, t):
        if self.algorithm_type == "dpmsolver++":
            return self.data_prediction_fn(x, t)
        return self.noise_prediction_fn(x, t)

    def _model_at(self, x, t):
        """The model at the host time ``t``, as a [B] tensor of x's type."""
        return self.model_fn(x, torch.full((x.shape[0],), float(t),
                                           dtype=x.dtype, device=x.device))

    # time grids (host numpy) ------------------------------------------------

    def get_time_steps(self, skip_type, t_T, t_0, N) -> np.ndarray:
        if skip_type == "logSNR":
            lam_T = float(self.ns.marginal_lambda_np(t_T))
            lam_0 = float(self.ns.marginal_lambda_np(t_0))
            lams = np.linspace(lam_T, lam_0, N + 1)
            return self.ns.inverse_lambda_np(lams)
        if skip_type == "time_uniform":
            return np.linspace(t_T, t_0, N + 1)
        if skip_type == "time_quadratic":
            return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
        raise ValueError(skip_type)

    @staticmethod
    def _singlestep_plan(steps: int, order: int) -> list[int]:
        """Order of each outer step ('DPM-Solver-fast', reference
        ``:484-540``)."""
        if order == 3:
            K = steps // 3 + 1
            return {0: [3] * (K - 2) + [2, 1],
                    1: [3] * (K - 1) + [1],
                    2: [3] * (K - 1) + [2]}[steps % 3]
        if order == 2:
            return [2] * (steps // 2) if steps % 2 == 0 \
                else [2] * (steps // 2) + [1]
        if order == 1:
            return [1] * steps
        raise ValueError(order)

    # updates: s, t (and r1, r2) host scalars --------------------------------

    def first_update(self, x, s, t, model_s=None):
        ns = self.ns
        h = ns.marginal_lambda(t) - ns.marginal_lambda(s)
        if model_s is None:
            model_s = self._model_at(x, s)
        if self.algorithm_type == "dpmsolver++":
            x_t = (float(ns.marginal_std(t) / ns.marginal_std(s)) * x
                   - float(ns.marginal_alpha(t) * np.expm1(-h)) * model_s)
        else:
            la_s = ns.marginal_log_mean_coeff(s)
            la_t = ns.marginal_log_mean_coeff(t)
            x_t = (float(np.exp(la_t - la_s)) * x
                   - float(ns.marginal_std(t) * np.expm1(h)) * model_s)
        return x_t, model_s

    def second_update(self, x, s, t, r1=0.5, model_s=None,
                      solver_type="dpmsolver"):
        ns = self.ns
        r1 = 0.5 if r1 is None else r1
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        if model_s is None:
            model_s = self._model_at(x, s)
        if self.algorithm_type == "dpmsolver++":
            sig_s, sig_s1, sig_t = (ns.marginal_std(v) for v in (s, s1, t))
            a_s1, a_t = ns.marginal_alpha(s1), ns.marginal_alpha(t)
            x_s1 = float(sig_s1 / sig_s) * x \
                - float(a_s1 * np.expm1(-r1 * h)) * model_s
            model_s1 = self._model_at(x_s1, s1)
            if solver_type == "dpmsolver":
                x_t = (float(sig_t / sig_s) * x
                       - float(a_t * np.expm1(-h)) * model_s
                       - float((0.5 / r1) * a_t * np.expm1(-h))
                       * (model_s1 - model_s))
            else:   # taylor
                x_t = (float(sig_t / sig_s) * x
                       - float(a_t * np.expm1(-h)) * model_s
                       + float((1.0 / r1) * a_t * (np.expm1(-h) / h + 1.0))
                       * (model_s1 - model_s))
        else:
            la_s, la_s1, la_t = (ns.marginal_log_mean_coeff(v)
                                 for v in (s, s1, t))
            sig_s1, sig_t = ns.marginal_std(s1), ns.marginal_std(t)
            x_s1 = float(np.exp(la_s1 - la_s)) * x \
                - float(sig_s1 * np.expm1(r1 * h)) * model_s
            model_s1 = self._model_at(x_s1, s1)
            if solver_type == "dpmsolver":
                x_t = (float(np.exp(la_t - la_s)) * x
                       - float(sig_t * np.expm1(h)) * model_s
                       - float((0.5 / r1) * sig_t * np.expm1(h))
                       * (model_s1 - model_s))
            else:
                x_t = (float(np.exp(la_t - la_s)) * x
                       - float(sig_t * np.expm1(h)) * model_s
                       - float((1.0 / r1) * sig_t * (np.expm1(h) / h - 1.0))
                       * (model_s1 - model_s))
        return x_t, (model_s, model_s1)

    def third_update(self, x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0, model_s=None,
                     model_s1=None, solver_type="dpmsolver"):
        ns = self.ns
        r1 = 1.0 / 3.0 if r1 is None else r1
        r2 = 2.0 / 3.0 if r2 is None else r2
        lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        if model_s is None:
            model_s = self._model_at(x, s)
        if self.algorithm_type == "dpmsolver++":
            sig_s, sig_s1, sig_s2, sig_t = (ns.marginal_std(v)
                                            for v in (s, s1, s2, t))
            a_s1, a_s2, a_t = (ns.marginal_alpha(v) for v in (s1, s2, t))
            phi_11 = np.expm1(-r1 * h)
            phi_12 = np.expm1(-r2 * h)
            phi_1 = np.expm1(-h)
            phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            if model_s1 is None:
                x_s1 = float(sig_s1 / sig_s) * x \
                    - float(a_s1 * phi_11) * model_s
                model_s1 = self._model_at(x_s1, s1)
            x_s2 = (float(sig_s2 / sig_s) * x
                    - float(a_s2 * phi_12) * model_s
                    + float(r2 / r1 * a_s2 * phi_22) * (model_s1 - model_s))
            model_s2 = self._model_at(x_s2, s2)
            if solver_type == "dpmsolver":
                x_t = (float(sig_t / sig_s) * x
                       - float(a_t * phi_1) * model_s
                       + float((1.0 / r2) * a_t * phi_2)
                       * (model_s2 - model_s))
            else:
                D1_0 = (1.0 / r1) * (model_s1 - model_s)
                D1_1 = (1.0 / r2) * (model_s2 - model_s)
                D1 = (r2 * D1_0 - r1 * D1_1) / (r2 - r1)
                D2 = 2.0 * (D1_1 - D1_0) / (r2 - r1)
                x_t = (float(sig_t / sig_s) * x
                       - float(a_t * phi_1) * model_s
                       + float(a_t * phi_2) * D1
                       - float(a_t * phi_3) * D2)
        else:
            la_s, la_s1, la_s2, la_t = (ns.marginal_log_mean_coeff(v)
                                        for v in (s, s1, s2, t))
            sig_s1, sig_s2, sig_t = (ns.marginal_std(v)
                                     for v in (s1, s2, t))
            phi_11 = np.expm1(r1 * h)
            phi_12 = np.expm1(r2 * h)
            phi_1 = np.expm1(h)
            phi_22 = np.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            phi_3 = phi_2 / h - 0.5
            if model_s1 is None:
                x_s1 = float(np.exp(la_s1 - la_s)) * x \
                    - float(sig_s1 * phi_11) * model_s
                model_s1 = self._model_at(x_s1, s1)
            x_s2 = (float(np.exp(la_s2 - la_s)) * x
                    - float(sig_s2 * phi_12) * model_s
                    - float(r2 / r1 * sig_s2 * phi_22)
                    * (model_s1 - model_s))
            model_s2 = self._model_at(x_s2, s2)
            if solver_type == "dpmsolver":
                x_t = (float(np.exp(la_t - la_s)) * x
                       - float(sig_t * phi_1) * model_s
                       - float((1.0 / r2) * sig_t * phi_2)
                       * (model_s2 - model_s))
            else:
                D1_0 = (1.0 / r1) * (model_s1 - model_s)
                D1_1 = (1.0 / r2) * (model_s2 - model_s)
                D1 = (r2 * D1_0 - r1 * D1_1) / (r2 - r1)
                D2 = 2.0 * (D1_1 - D1_0) / (r2 - r1)
                x_t = (float(np.exp(la_t - la_s)) * x
                       - float(sig_t * phi_1) * model_s
                       - float(sig_t * phi_2) * D1
                       - float(sig_t * phi_3) * D2)
        return x_t, (model_s, model_s1, model_s2)

    def singlestep_update(self, x, s, t, order, solver_type="dpmsolver",
                          r1=None, r2=None):
        if order == 1:
            return self.first_update(x, s, t)[0]
        if order == 2:
            return self.second_update(x, s, t, r1=r1,
                                      solver_type=solver_type)[0]
        if order == 3:
            return self.third_update(x, s, t, r1=r1, r2=r2,
                                     solver_type=solver_type)[0]
        raise ValueError(order)

    # multistep updates -------------------------------------------------------

    def multistep_second_update(self, x, model_prev, t_prev, t,
                                solver_type="dpmsolver"):
        ns = self.ns
        m1, m0 = model_prev[-2], model_prev[-1]
        t1, t0 = t_prev[-2], t_prev[-1]
        lam1, lam0, lam_t = (ns.marginal_lambda(v) for v in (t1, t0, t))
        h0, h = lam0 - lam1, lam_t - lam0
        r0 = h0 / h
        D1_0 = float(1.0 / r0) * (m0 - m1)
        if self.algorithm_type == "dpmsolver++":
            sig0, sig_t = ns.marginal_std(t0), ns.marginal_std(t)
            a_t = ns.marginal_alpha(t)
            phi_1 = np.expm1(-h)
            if solver_type == "dpmsolver":
                return (float(sig_t / sig0) * x
                        - float(a_t * phi_1) * m0
                        - 0.5 * float(a_t * phi_1) * D1_0)
            return (float(sig_t / sig0) * x
                    - float(a_t * phi_1) * m0
                    + float(a_t * (phi_1 / h + 1.0)) * D1_0)
        la0 = ns.marginal_log_mean_coeff(t0)
        la_t = ns.marginal_log_mean_coeff(t)
        sig_t = ns.marginal_std(t)
        phi_1 = np.expm1(h)
        if solver_type == "dpmsolver":
            return (float(np.exp(la_t - la0)) * x
                    - float(sig_t * phi_1) * m0
                    - 0.5 * float(sig_t * phi_1) * D1_0)
        return (float(np.exp(la_t - la0)) * x
                - float(sig_t * phi_1) * m0
                - float(sig_t * (phi_1 / h - 1.0)) * D1_0)

    def multistep_third_update(self, x, model_prev, t_prev, t,
                               solver_type="dpmsolver"):
        ns = self.ns
        m2, m1, m0 = model_prev[-3], model_prev[-2], model_prev[-1]
        t2, t1, t0 = t_prev[-3], t_prev[-2], t_prev[-1]
        lam2, lam1, lam0, lam_t = (ns.marginal_lambda(v)
                                   for v in (t2, t1, t0, t))
        h1, h0, h = lam1 - lam2, lam0 - lam1, lam_t - lam0
        r0, r1 = h0 / h, h1 / h
        D1_0 = float(1.0 / r0) * (m0 - m1)
        D1_1 = float(1.0 / r1) * (m1 - m2)
        D1 = D1_0 + float(r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = float(1.0 / (r0 + r1)) * (D1_0 - D1_1)
        if self.algorithm_type == "dpmsolver++":
            sig0, sig_t = ns.marginal_std(t0), ns.marginal_std(t)
            a_t = ns.marginal_alpha(t)
            phi_1 = np.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return (float(sig_t / sig0) * x
                    - float(a_t * phi_1) * m0
                    + float(a_t * phi_2) * D1
                    - float(a_t * phi_3) * D2)
        la0 = ns.marginal_log_mean_coeff(t0)
        la_t = ns.marginal_log_mean_coeff(t)
        sig_t = ns.marginal_std(t)
        phi_1 = np.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return (float(np.exp(la_t - la0)) * x
                - float(sig_t * phi_1) * m0
                - float(sig_t * phi_2) * D1
                - float(sig_t * phi_3) * D2)

    def multistep_update(self, x, model_prev, t_prev, t, order,
                         solver_type="dpmsolver"):
        if order == 1:
            return self.first_update(x, t_prev[-1], t,
                                     model_s=model_prev[-1])[0]
        if order == 2:
            return self.multistep_second_update(x, model_prev, t_prev, t,
                                                solver_type=solver_type)
        if order == 3:
            return self.multistep_third_update(x, model_prev, t_prev, t,
                                               solver_type=solver_type)
        raise ValueError(order)

    def denoise_to_zero_fn(self, x, s):
        return self.data_prediction_fn(x, s)

    # orchestration ------------------------------------------------------------

    @torch.no_grad()
    def sample(self, x, *, steps: int = 20, t_start=None, t_end=None,
               order: int = 2, skip_type: str = "time_uniform",
               method: str = "multistep", lower_order_final: bool = True,
               denoise_to_zero: bool = False, solver_type: str = "dpmsolver",
               atol: float = 0.0078, rtol: float = 0.05):
        """The reference's ``sample`` (``deps/dpm_solver_pytorch.py:
        1047-1251``): ``method`` is ``"multistep"``, ``"singlestep"``,
        ``"singlestep_fixed"`` or ``"adaptive"``."""
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start

        if method == "adaptive":
            return self.adaptive(x, order=order, t_T=t_T, t_0=t_0,
                                 atol=atol, rtol=rtol,
                                 solver_type=solver_type)

        if method == "multistep":
            if steps < order:
                raise ValueError(f"multistep needs steps >= order, got "
                                 f"{steps} < {order}")
            ts = [float(v) for v in self.get_time_steps(skip_type, t_T, t_0,
                                                        steps)]
            t_prev = [ts[0]]
            model_prev = [self._model_at(x, ts[0])]
            for step in range(1, order):
                x = self.multistep_update(x, model_prev, t_prev, ts[step],
                                          step, solver_type=solver_type)
                t_prev.append(ts[step])
                model_prev.append(self._model_at(x, ts[step]))
            for step in range(order, steps + 1):
                if lower_order_final and steps < 10:
                    step_order = min(order, steps + 1 - step)
                else:
                    step_order = order
                x = self.multistep_update(x, model_prev, t_prev, ts[step],
                                          step_order, solver_type=solver_type)
                t_prev = t_prev[1:] + [ts[step]]
                if step < steps:
                    model_prev = model_prev[1:] + [
                        self._model_at(x, ts[step])]
        elif method in ("singlestep", "singlestep_fixed"):
            if method == "singlestep":
                orders = self._singlestep_plan(steps, order)
                if skip_type == "logSNR":
                    ts_outer = self.get_time_steps(skip_type, t_T, t_0,
                                                   len(orders))
                else:
                    full = self.get_time_steps(skip_type, t_T, t_0, steps)
                    ts_outer = full[np.cumsum([0] + orders)]
            else:
                K = steps // order
                orders = [order] * K
                ts_outer = self.get_time_steps(skip_type, t_T, t_0, K)
            for i, od in enumerate(orders):
                s_i, t_i = float(ts_outer[i]), float(ts_outer[i + 1])
                ts_inner = self.get_time_steps(skip_type, s_i, t_i, od)
                lam = self.ns.marginal_lambda_np(ts_inner)
                h = lam[-1] - lam[0]
                r1 = None if od <= 1 else float((lam[1] - lam[0]) / h)
                r2 = None if od <= 2 else float((lam[2] - lam[0]) / h)
                x = self.singlestep_update(x, s_i, t_i, od,
                                           solver_type=solver_type,
                                           r1=r1, r2=r2)
        else:
            raise ValueError(method)

        if denoise_to_zero:
            x = self.denoise_to_zero_fn(x, torch.full(
                (x.shape[0],), float(t_0), dtype=x.dtype, device=x.device))
        return x

    def inverse(self, x, *, steps: int = 20, t_start=None, t_end=None,
                order: int = 2, skip_type: str = "time_uniform",
                method: str = "multistep", lower_order_final: bool = True,
                solver_type: str = "dpmsolver"):
        """Inversion x_0 -> x_T: the solver with the time range flipped
        (reference ``:1032-1045``)."""
        t_0 = 1.0 / self.ns.total_N if t_start is None else t_start
        t_T = self.ns.T if t_end is None else t_end
        return self.sample(x, steps=steps, t_start=t_0, t_end=t_T,
                           order=order, skip_type=skip_type, method=method,
                           lower_order_final=lower_order_final,
                           solver_type=solver_type)

    def adaptive(self, x, *, order: int, t_T: float, t_0: float,
                 h_init: float = 0.05, atol: float = 0.0078,
                 rtol: float = 0.05, theta: float = 0.9,
                 t_err: float = 1e-5, solver_type: str = "dpmsolver"):
        """DPM-Solver-12/23 (reference ``:956-1030``): a host loop whose
        times and step sizes are float32 scalars, as JAX's
        ``while_loop`` state, reading the error norm once a step."""
        ns = self.ns
        f32 = np.float32
        lam_0 = f32(ns.marginal_lambda(f32(t_0)))

        if order == 2:
            def lower(x, s, t):
                return self.first_update(x, s, t)

            def higher(x, s, t, model_s):
                return self.second_update(x, s, t, r1=0.5, model_s=model_s,
                                          solver_type=solver_type)[0]
        elif order == 3:
            def lower(x, s, t):
                x_t, ms = self.second_update(x, s, t, r1=1.0 / 3.0,
                                             solver_type=solver_type)
                return x_t, ms[0]

            def higher(x, s, t, model_s):
                return self.third_update(x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0,
                                         model_s=model_s,
                                         solver_type=solver_type)[0]
        else:
            raise ValueError(order)

        x_prev, s, h, nfe = x, f32(t_T), f32(h_init), 0
        while abs(s - f32(t_0)) > t_err and nfe < 10_000:
            t = f32(ns.inverse_lambda(f32(ns.marginal_lambda(s) + h)))
            x_lower, model_s = lower(x, s, t)
            x_higher = higher(x, s, t, model_s)
            delta = torch.clamp(rtol * torch.maximum(x_lower.abs(),
                                                     x_prev.abs()), min=atol)
            err = f32(float(torch.sqrt(torch.mean(
                ((x_higher - x_lower) / delta) ** 2))))
            if err <= 1.0:
                x, x_prev, s = x_higher, x_lower, t
            h = f32(min(f32(theta * h * err ** f32(-1.0 / order)),
                        f32(lam_0 - f32(ns.marginal_lambda(s)))))
            nfe += order
        return x
