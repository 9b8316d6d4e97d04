"""SD3 sharpness-control weights -> CoeffMatrix (the engine form).

Copy of ``naturaldiffusion_tpu/coeffs/sd3.py`` (numpy only), kept here so the
port never imports the JAX package.

The reference's SD3 NI loop (``src/SD3NaturalInference.py:201-223``) is a
host-side reprojection:

    curr_x0_k  = sum_{j<=k-1} w[k-1,j] x0_j / sum_j w[k-1,j]
    model_in_k = sigma_k * noise + (1 - sigma_k) * curr_x0_k

That update is affine in ``{x0_j, noise}``, so it IS a Natural-Inference
schedule: row ``k`` of the x0 matrix is the row-normalized weight row scaled
by ``(1 - sigma_{k+1})`` and the eps matrix has only column 0 (``sigma_{k+1}``
on the initial noise) — deterministic, one run of
:mod:`naturaldiffusion_tpu_torch.engine` instead of the reference's loop.

The final step has ``sigma_n = 0``: the engine's last state is exactly the
reference's closing ``weighted_sum(seq_x0, weights)``.
"""

from __future__ import annotations

import numpy as np

from .matrix import CoeffMatrix


def flow_match_sigmas(num_step: int, *, shift: float = 3.0,
                      num_train: int = 1000) -> tuple[np.ndarray, np.ndarray]:
    """(timesteps, sigmas) of diffusers' FlowMatchEulerDiscreteScheduler
    ``set_timesteps`` (SD3 config: shift=3).  sigmas has a trailing 0."""
    ts = np.linspace(num_train, 1.0, num_step)
    sigmas = ts / num_train
    sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    timesteps = sigmas * num_train
    return timesteps, np.append(sigmas, 0.0)


def sd3_euler_weights(num_step: int = 28, *, shift: float = 3.0,
                      cliplen: int = 0) -> np.ndarray:
    """Vanilla flow-Euler as NI weights (``sd_euler_natural_inference_tx``,
    ``src/SD3NaturalInference.py:61-130``): column j carries the Euler
    increment ``sigma_j - sigma_{j+1}``, so the row sums telescope to
    ``1 - sigma_{k+1}`` and the NI trajectory equals the Euler recursion
    ``z_{k+1} = z_k + (sigma_k - sigma_{k+1}) (x0_k - eps)`` exactly.
    ``cliplen > 0`` keeps only the last ``cliplen`` diagonals (the
    reference's sharpness-control clipping knob)."""
    _, sigmas = flow_match_sigmas(num_step, shift=shift)
    incr = sigmas[:-1] - sigmas[1:]                   # [n], > 0
    w = np.tril(np.broadcast_to(incr[None, :], (num_step, num_step)).copy())
    if cliplen > 0:
        w *= (np.arange(num_step)[None, :]
              > np.arange(num_step)[:, None] - cliplen)
    return w


def sd3_weight_matrix(weights: np.ndarray, num_step: int = 28, *,
                      shift: float = 3.0) -> CoeffMatrix:
    """Lift a (possibly "sharp") SD3 weight CSV matrix into a CoeffMatrix.

    ``weights``: ``[n, n]`` lower-triangular raw weights
    (``weights/sd3_step_28_weight[_sharp].csv``); rows are normalized by
    their sum exactly as the reference's ``weighted_sum``
    (``src/SD3NaturalInference.py:157-168``)."""
    n = num_step
    w = np.tril(np.asarray(weights, np.float64)[:n, :n])
    row_sum = w.sum(axis=1, keepdims=True)
    if np.any(row_sum == 0):
        raise ValueError("SD3 weight matrix has an all-zero row")
    wn = w / row_sum

    timesteps, sigmas = flow_match_sigmas(n, shift=shift)
    x0 = (1.0 - sigmas[1:, None]) * wn          # row k produces z_{k+1}
    eps = np.zeros((n, n + 1))
    eps[:, 0] = sigmas[1:]
    node = np.stack([np.append(timesteps, 0.0), 1.0 - sigmas, sigmas], axis=1)
    return CoeffMatrix(x0=x0, eps=eps, node=node)
