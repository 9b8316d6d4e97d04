"""Reverse-diffusion-sampler equivalent-coefficient check (paper appendix).

Copy of ``naturaldiffusion_tpu/coeffs/reverse_diffusion.py`` (numpy only), kept here so the
port never imports the JAX package.

Rebuild of ``src/AnalyzeReverseDiffusionSampler.py:4-124``: closed-form
verification that the reverse-diffusion SDE/ODE discretizations (score-SDE's
``ReverseDiffusionPredictor`` with x_t coefficient ``2 - sqrt(1-beta) -
beta/(1-abar)``) telescope into equivalent marginal coefficients matching the
ideal (sqrt(abar), sqrt(1-abar)).  Print-only in the reference (no npz);
here it returns arrays so it is testable.
"""

from __future__ import annotations

import numpy as np


def _skip_tables(skip_step: int):
    betas = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
    alphas_bar = np.cumprod(1.0 - betas)
    s_ab = alphas_bar[::skip_step]
    s_alphas = np.empty_like(s_ab)
    s_alphas[0] = s_ab[0]
    s_alphas[1:] = s_ab[1:] / s_ab[:-1]
    return alphas_bar, s_ab, 1.0 - s_alphas


def sde_equivalent_coeff(skip_step: int = 1, stride: int = 10):
    """Returns rows (start, pred_signal, pred_noise, true_signal, true_noise)
    for the reverse-diffusion SDE (``sde_equivalent_coeff_tx``)."""
    alphas_bar, s_ab, s_betas = _skip_tables(skip_step)
    std = np.sqrt(s_betas)
    coeff_x0 = s_betas * np.sqrt(s_ab) / (1.0 - s_ab)
    coeff_xt = 2.0 - np.sqrt(1.0 - s_betas) - s_betas / (1.0 - s_ab)

    end = len(s_ab)
    rows = []
    for start in range(0, end, stride):
        epss = [np.prod(coeff_xt[start:end])]
        epss += [std[i] * np.prod(coeff_xt[start:i])
                 for i in range(end - 1, start - 1, -1)]
        xzs = [coeff_x0[i] * np.prod(coeff_xt[start:i])
               for i in range(end - 1, start - 1, -1)]
        pred_noise = float(np.linalg.norm(epss))
        pred_signal = float(np.sum(xzs))
        true_signal = float(np.sqrt(alphas_bar[start * skip_step]))
        true_noise = float(np.sqrt(1.0 - alphas_bar[start * skip_step]))
        rows.append((start, pred_signal, pred_noise, true_signal, true_noise))
    return np.asarray(rows)


def ode_equivalent_coeff(skip_step: int = 1, stride: int = 10):
    """Probability-flow variant (half-beta score term,
    ``ode_equivalent_coeff_tx``)."""
    alphas_bar, s_ab, s_betas = _skip_tables(skip_step)
    coeff_x0 = 0.5 * s_betas * np.sqrt(s_ab) / (1.0 - s_ab)
    coeff_xt = 2.0 - np.sqrt(1.0 - s_betas) - 0.5 * s_betas / (1.0 - s_ab)

    end = len(s_ab)
    rows = []
    for start in range(0, end, stride):
        pred_noise = float(np.prod(coeff_xt[start:end]))
        xzs = [coeff_x0[i] * np.prod(coeff_xt[start:i])
               for i in range(end - 1, start - 1, -1)]
        pred_signal = float(np.sum(xzs))
        true_signal = float(np.sqrt(alphas_bar[start * skip_step]))
        true_noise = float(np.sqrt(1.0 - alphas_bar[start * skip_step]))
        rows.append((start, pred_signal, pred_noise, true_signal, true_noise))
    return np.asarray(rows)
