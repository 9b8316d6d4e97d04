"""Score-matching losses and the optimizer (port of
``naturaldiffusion_tpu/train/losses.py``, itself a rebuild of the
reference's ``deps/score_sde_pytorch/losses.py:26-210``).

* :func:`make_optimizer` -- the JAX package's optax chain, written out:
  ``clip_by_global_norm`` (updates times ``max_norm / |g|`` only where
  ``|g| >= max_norm``), ``scale_by_adam`` (b2 0.999, eps outside the square
  root) and ``scale_by_learning_rate(linear_schedule(0, lr, warmup))``,
  whose schedule reads its count before incrementing it, so the first
  update has learning rate 0.  Host loops of ``torch._foreach_*`` ops over
  the parameters, updated in place.
* :func:`sde_loss_fn`, :func:`smld_loss_fn`, :func:`ddpm_loss_fn` -- each
  split into its draws (``*_draws``: the times or labels and the noise,
  from an explicit ``torch.Generator``) and the loss given those draws
  (``*_loss_given``), so a test can feed the JAX package's own draws.

``apply_fn(params, x, label)`` is the raw network; the label conventions
are :func:`..sde.get_score_fn`'s.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..sde import SDE, VESDE, VPSDE, _bcast, get_score_fn


# -- the optimizer ------------------------------------------------------------


@dataclasses.dataclass
class OptState:
    """The chain's state: Adam's ``count``, ``mu`` and ``nu`` (lists in the
    order of the parameters) and the schedule's ``sched_count``."""
    count: int
    mu: list
    nu: list
    sched_count: int


class Optimizer:
    """Adam with a linear warm-up of the learning rate and a global-norm
    clip, optax's order of operations (see the module docstring).
    :meth:`init` makes the state, :meth:`update` applies one step to the
    parameters in place."""

    def __init__(self, lr: float = 2e-4, beta1: float = 0.9,
                 eps: float = 1e-8, warmup: int = 5000,
                 grad_clip: float = 1.0, beta2: float = 0.999):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.warmup = max(warmup, 1)
        self.grad_clip = grad_clip

    def init(self, params) -> OptState:
        params = list(params)
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params], 0)

    def learning_rate(self, count: int) -> np.float32:
        """optax's ``linear_schedule(0, lr, warmup)`` at ``count``, in
        float32: ``(0 - lr) * (1 - clip(count, 0, warmup) / warmup) +
        lr``."""
        f32 = np.float32
        frac = f32(1) - f32(min(max(count, 0), self.warmup)) / f32(self.warmup)
        return (f32(0.0) - f32(self.lr)) * frac + f32(self.lr)

    def clip(self, grads, norm=None):
        """``clip_by_global_norm``: ``g`` where ``|g| < max_norm``, else
        ``(g / |g|) * max_norm``; decided on the device, no host read.
        ``norm``: the global norm when ``grads`` are shards of it."""
        if self.grad_clip <= 0:
            return grads
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        return torch._foreach_mul(
            grads, torch.where(keep, one, one * self.grad_clip))

    @torch.no_grad()
    def update(self, params, grads, state: OptState,
               grad_norm=None) -> OptState:
        """One step on ``params`` (a list of tensors, updated in place) from
        ``grads``; the moments are updated in place, the counts advanced.
        ``grad_norm``: the gradients' global norm, for shards of them."""
        params, grads = list(params), self.clip(list(grads), grad_norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(count))
        c2 = float(f32(1) - f32(b2) ** f32(count))
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, c2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(state.mu, c1), den)
        torch._foreach_mul_(upd, float(-self.learning_rate(state.sched_count)))
        torch._foreach_add_(params, upd)
        state.count, state.sched_count = count, state.sched_count + 1
        return state


def make_optimizer(lr: float = 2e-4, beta1: float = 0.9, eps: float = 1e-8,
                   warmup: int = 5000, grad_clip: float = 1.0) -> Optimizer:
    """Adam + linear warm-up + global-norm clip (reference ``losses.py:
    26-53``, ``optimization_manager``)."""
    return Optimizer(lr=lr, beta1=beta1, eps=eps, warmup=warmup,
                     grad_clip=grad_clip)


# -- the continuous-time DSM loss -------------------------------------------


def _reduce(losses, b: int, reduce_mean: bool):
    losses = losses.reshape(b, -1)
    per = (torch.mean(losses, -1) if reduce_mean
           else 0.5 * torch.sum(losses, -1))
    return torch.mean(per)


def sde_draws(sde: SDE, batch, generator: torch.Generator | None = None,
              eps: float = 1e-5):
    """``(t, z)``: times uniform in ``[eps, T)`` and standard normal noise
    like ``batch``, float32 on its device."""
    b = batch.shape[0]
    t = torch.rand(b, generator=generator, device=batch.device) \
        * (sde.T - eps) + eps
    z = torch.randn(batch.shape, generator=generator, device=batch.device)
    return t, z


def sde_loss_given(sde: SDE, apply_fn, params, batch, t, z, *,
                   reduce_mean: bool = True,
                   likelihood_weighting: bool = False,
                   continuous: bool = True):
    """The DSM loss (reference ``get_sde_loss_fn``, ``losses.py:55-101``)
    at the draws ``t``, ``z``."""
    b = batch.shape[0]
    mean, std = sde.marginal_prob(batch, t)
    std = torch.atleast_1d(std)
    perturbed = mean + _bcast(std, batch) * z
    score_fn = get_score_fn(sde, lambda x, tl: apply_fn(params, x, tl),
                            continuous=continuous)
    score = score_fn(perturbed, t)
    if not likelihood_weighting:
        losses = torch.square(score * _bcast(std, batch) + z)
    else:
        g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
        losses = torch.square(score + z / _bcast(std, batch))
        losses = losses * _bcast(g2, batch)
    return _reduce(losses, b, reduce_mean)


def sde_loss_fn(sde: SDE, apply_fn, params, generator, batch, *,
                train: bool = True, reduce_mean: bool = True,
                likelihood_weighting: bool = False, eps: float = 1e-5,
                continuous: bool = True, draws=None):
    """Continuous-time DSM loss (JAX ``sde_loss_fn``): draws from
    ``generator`` unless ``draws = (t, z)`` are given."""
    t, z = draws if draws is not None else sde_draws(sde, batch, generator,
                                                     eps)
    return sde_loss_given(sde, apply_fn, params, batch, t, z,
                          reduce_mean=reduce_mean,
                          likelihood_weighting=likelihood_weighting,
                          continuous=continuous)


# -- the discrete losses ----------------------------------------------------


def discrete_draws(n: int, batch, generator: torch.Generator | None = None):
    """``(labels, z)``: integer labels uniform in ``[0, n)`` and standard
    normal noise like ``batch``."""
    labels = torch.randint(0, n, (batch.shape[0],), generator=generator,
                           device=batch.device)
    z = torch.randn(batch.shape, generator=generator, device=batch.device)
    return labels, z


def smld_loss_given(vesde: VESDE, apply_fn, params, batch, labels, z, *,
                    reduce_mean: bool = False):
    """Discrete SMLD (NCSN) loss (reference ``losses.py:104-128``) at the
    draws."""
    b = batch.shape[0]
    sigmas = torch.exp(torch.linspace(
        math.log(vesde.sigma_max), math.log(vesde.sigma_min), vesde.N,
        dtype=torch.float32, device=batch.device))
    sigma = sigmas[labels]
    noise = z * _bcast(sigma, batch)
    perturbed = batch + noise
    score = apply_fn(params, perturbed, labels)
    target = -noise / _bcast(sigma ** 2, batch)
    losses = torch.square(score - target).reshape(b, -1) \
        * (sigma ** 2)[:, None]
    per = torch.mean(losses, -1) if reduce_mean else 0.5 * torch.sum(
        losses, -1)
    return torch.mean(per)


def smld_loss_fn(vesde: VESDE, apply_fn, params, generator, batch, *,
                 reduce_mean: bool = False, draws=None):
    labels, z = draws if draws is not None else discrete_draws(
        vesde.N, batch, generator)
    return smld_loss_given(vesde, apply_fn, params, batch, labels, z,
                           reduce_mean=reduce_mean)


def ddpm_loss_given(vpsde: VPSDE, apply_fn, params, batch, labels, z, *,
                    reduce_mean: bool = True):
    """Discrete DDPM eps-matching loss (reference ``losses.py:131-149``) at
    the draws."""
    b = batch.shape[0]
    betas = torch.linspace(vpsde.beta_min / vpsde.N, vpsde.beta_max / vpsde.N,
                           vpsde.N, dtype=torch.float32, device=batch.device)
    abar = torch.cumprod(1.0 - betas, 0)
    a = abar[labels]
    perturbed = _bcast(torch.sqrt(a), batch) * batch \
        + _bcast(torch.sqrt(1.0 - a), batch) * z
    pred = apply_fn(params, perturbed, labels)
    return _reduce(torch.square(pred - z), b, reduce_mean)


def ddpm_loss_fn(vpsde: VPSDE, apply_fn, params, generator, batch, *,
                 reduce_mean: bool = True, draws=None):
    labels, z = draws if draws is not None else discrete_draws(
        vpsde.N, batch, generator)
    return ddpm_loss_given(vpsde, apply_fn, params, batch, labels, z,
                           reduce_mean=reduce_mean)
