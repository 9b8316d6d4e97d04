"""The samplers as Natural-Inference matrices, in NumPy float64, and the NI
loop in float64.

``ddpm_matrix``: DDPM ancestral sampling (Ho et al. 2020) on the linear
beta schedule (1e-4 to 0.02 over 1000 steps), respaced to ``n`` evenly
spaced timesteps (improved-diffusion's ``space_timesteps``), written as the
closed-form products of the posterior's coefficients; its node table holds
each timestep's true marginal (alpha, sigma), and the final node is
(-1, 1, 0).  ``sd3_euler_matrix``: the sigmas of diffusers'
``FlowMatchEulerDiscreteScheduler`` with ``shift`` (SD3: 3), in
NaturalDiffusion's SD3 form (``src/SD3NaturalInference.py``): each step's
state is ``sigma_{k+1}`` times the initial noise plus the x0 predictions
so far weighted by the Euler increments ``sigma_j - sigma_{j+1}``.

Row k of ``x0`` and ``eps`` gives the state after step k over the x0
predictions so far and the noises (column 0 the initial noise, column j
the noise injected at step j - 1).
"""

from __future__ import annotations

import numpy as np
import torch


def _respaced(num_train: int, count: int) -> np.ndarray:
    stride = (num_train - 1) / (count - 1) if count > 1 else 1.0
    return np.array(sorted({round(i * stride) for i in range(count)}))


def ddpm_matrix(n: int, num_train: int = 1000):
    """-> (x0 [n, n], eps [n, n+1], node [n+1, 3]) of DDPM at ``n`` steps."""
    betas_all = np.linspace(1e-4, 0.02, num_train, dtype=np.float64)
    ab_all = np.cumprod(1.0 - betas_all)
    ts = _respaced(num_train, n)
    ab = ab_all[ts]
    ab_prev = np.append(1.0, ab[:-1])
    alphas = ab / ab_prev
    betas = 1.0 - alphas
    post_var = betas * (1.0 - ab_prev) / (1.0 - ab)
    std = np.sqrt(np.exp(np.log(np.append(1e-5, post_var[1:]))))
    c_x0 = np.sqrt(ab_prev) * betas / (1.0 - ab)
    c_xt = np.sqrt(alphas) * (1.0 - ab_prev) / (1.0 - ab)
    x0 = np.zeros((n, n))
    eps = np.zeros((n, n + 1))
    # sampling runs from grid index n-1 down to 0; step s (0-based) is
    # grid index n-1-s, and the state after step s is
    # prod(c_xt) eps_0 + sum over the steps so far of their x0 and noise
    for s in range(n):
        for j in range(s + 1):                  # x0 predicted at step j
            g = n - 1 - j
            x0[s, j] = c_x0[g] * np.prod(c_xt[n - 1 - s:g])
            eps[s, j + 1] = std[g] * np.prod(c_xt[n - 1 - s:g])
        eps[s, 0] = np.prod(c_xt[n - 1 - s:n])
    node = np.zeros((n + 1, 3))
    for k in range(n):
        g = n - 1 - k
        node[k] = (ts[g], np.sqrt(ab[g]), np.sqrt(1.0 - ab[g]))
    node[n] = (-1.0, 1.0, 0.0)
    return x0, eps, node


def sd3_euler_matrix(n: int = 28, shift: float = 3.0, num_train: int = 1000):
    """-> (x0, eps, node) of the shifted flow Euler sampler at ``n`` steps;
    node rows are (timestep, 1 - sigma, sigma)."""
    sig = np.linspace(num_train, 1.0, n) / num_train
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    sig = np.append(sig, 0.0)
    x0 = np.zeros((n, n))
    eps = np.zeros((n, n + 1))
    for k in range(n):
        x0[k, :k + 1] = sig[:k + 1] - sig[1:k + 2]
        eps[k, 0] = sig[k + 1]
    node = np.stack([np.append(sig[:-1] * num_train, 0.0), 1.0 - sig, sig],
                    axis=1)
    return x0, eps, node


@torch.no_grad()
def natural_inference(denoise, x0m, epsm, node, init, noises=None,
                      prediction: str = "eps"):
    """The NI loop in float64 on ``init``'s device: ``denoise(z, t)`` gets
    the state in float32 and step k's node time; its output is turned into
    x0 (``eps``: ``(z - sigma eps) / alpha``; ``v_flow``: ``z - sigma v``).
    ``noises`` [n, B, ...] are the injected noises, columns 1..n."""
    n = x0m.shape[0]
    dev = init.device
    cols = [init.double()]
    if noises is not None:
        cols += [noises[k].double() for k in range(n)]
    xs = []
    z = cols[0]
    for k in range(n):
        t, alpha, sigma = (float(v) for v in node[k])
        pred = denoise(z.float(), t).double()
        xs.append((z - sigma * pred) / alpha if prediction == "eps"
                  else z - sigma * pred)
        z = sum(float(x0m[k, j]) * xs[j] for j in range(k + 1))
        for j in range(min(len(cols), k + 2)):
            if epsm[k, j]:
                z = z + float(epsm[k, j]) * cols[j]
    return z.to(device=dev)
