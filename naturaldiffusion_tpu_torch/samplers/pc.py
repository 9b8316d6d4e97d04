"""Predictor-corrector sampling (port of ``naturaldiffusion_tpu/samplers/
pc.py``): the predictor and corrector registries, the PC sampler loop and
the probability-flow ODE sampler.

Step functions take their Gaussian noise as tensors, so a test can feed
them the numbers another implementation drew; the samplers draw them from
a ``torch.Generator`` on the state's device.  The time loops are Python
loops (the JAX package's ``lax.scan`` and ``lax.while_loop``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..device import resolve_device
from ..sde import SDE, VESDE, VPSDE, _bcast, _step_index, _vp_betas

_PREDICTORS: dict[str, Callable] = {}
_CORRECTORS: dict[str, Callable] = {}


def register_predictor(name):
    def deco(fn):
        _PREDICTORS[name] = fn
        return fn
    return deco


def register_corrector(name):
    def deco(fn):
        _CORRECTORS[name] = fn
        return fn
    return deco


def _lookup(table, kind, name):
    if name not in table:
        raise KeyError(f"unknown {kind} {name!r}; known: {sorted(table)}")
    return table[name]


def get_predictor(name: str):
    return _lookup(_PREDICTORS, "predictor", name)


def get_corrector(name: str):
    return _lookup(_CORRECTORS, "corrector", name)


# -- predictors (JAX pc.py:50-100): (sde, score_fn, x, t, z) -> (x, x_mean)


@register_predictor("euler_maruyama")
def euler_maruyama(sde: SDE, score_fn, x, t, z):
    """One Euler-Maruyama step of the reverse SDE (JAX ``pc.py:51``)."""
    dt = -1.0 / sde.N
    drift, diffusion = sde.reverse(score_fn).sde(x, t)
    x_mean = x + drift * dt
    return (x_mean + _bcast(torch.atleast_1d(diffusion), x)
            * math.sqrt(-dt) * z, x_mean)


@register_predictor("reverse_diffusion")
def reverse_diffusion(sde: SDE, score_fn, x, t, z):
    """One reverse-diffusion predictor step (JAX ``pc.py:63``), noise
    ``z`` like x.  Returns ``(x, x_mean)``."""
    f, G = sde.reverse(score_fn).discretize(x, t)
    x_mean = x - f
    return x_mean + _bcast(torch.atleast_1d(G), x) * z, x_mean


@register_predictor("ancestral_sampling")
def ancestral_sampling(sde: SDE, score_fn, x, t, z):
    """The DDPM (VP) or SMLD (VE) ancestral step (JAX ``pc.py:72``)."""
    if isinstance(sde, VPSDE):
        beta = _vp_betas(sde, t.device)[_step_index(sde, t)].to(t.dtype)
        score = score_fn(x, t)
        x_mean = ((x + _bcast(beta, x) * score)
                  / torch.sqrt(1.0 - _bcast(beta, x)))
        return x_mean + _bcast(torch.sqrt(beta), x) * z, x_mean
    if isinstance(sde, VESDE):
        sigma, adj = sde.step_sigmas(t)
        score = score_fn(x, t)
        x_mean = x + score * _bcast(sigma ** 2 - adj ** 2, x)
        std = torch.sqrt(adj ** 2 * (sigma ** 2 - adj ** 2) / sigma ** 2)
        return x_mean + _bcast(std, x) * z, x_mean
    raise NotImplementedError(type(sde))


@register_predictor("none")
def none_predictor(sde, score_fn, x, t, z):
    return x, x


# -- correctors (JAX pc.py:103-164): one step per entry of ``noises``


def _langevin_alpha(sde, t):
    """1 - beta of the step for VP (the DDPM discretisation), else 1."""
    if isinstance(sde, VPSDE):
        beta = _vp_betas(sde, t.device)[_step_index(sde, t)]
        return (1.0 - beta).to(t.dtype)
    return torch.ones_like(t)


@register_corrector("langevin")
def langevin(sde: SDE, score_fn, x, t, noises, *, snr: float):
    """Langevin corrector (JAX ``pc.py:106``), one step per entry of
    ``noises`` (each like x), the step size from the gradient's and the
    noise's mean norms.  Returns ``(x, x)``."""
    alpha = _langevin_alpha(sde, t)
    for noise in noises:
        grad = score_fn(x, t)
        gn = torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1),
                                      dim=-1).mean()
        nn_ = torch.linalg.vector_norm(noise.reshape(noise.shape[0], -1),
                                       dim=-1).mean()
        step = (snr * nn_ / gn) ** 2 * 2 * alpha
        x_mean = x + _bcast(step, x) * grad
        x = x_mean + _bcast(torch.sqrt(step * 2), x) * noise
    return x, x


@register_corrector("ald")
def ald(sde: SDE, score_fn, x, t, noises, *, snr: float):
    """Annealed Langevin (JAX ``pc.py:132``): the NCSNv2 step size, from
    the marginal std instead of the gradient norm."""
    alpha = _langevin_alpha(sde, t)
    std = sde.marginal_prob(x, t)[1]
    step = (snr * std) ** 2 * 2 * alpha
    for noise in noises:
        grad = score_fn(x, t)
        x_mean = x + _bcast(step, x) * grad
        x = x_mean + _bcast(torch.sqrt(step * 2), x) * noise
    return x, x


@register_corrector("none")
def none_corrector(sde, score_fn, x, t, noises, *, snr: float = 0.0):
    return x, x


# -- PC sampler (JAX pc.py:167-196)


def get_pc_sampler(sde: SDE, score_fn, shape, *, predictor="reverse_diffusion",
                   corrector="none", snr: float = 0.16, n_steps: int = 1,
                   denoise: bool = True, eps: float = 1e-3, device="cuda"):
    """Returns ``sampler(generator, *, prior=None, noises=None) -> (x,
    nfe)`` (JAX ``pc.py:167``): a prior sample, then for each of ``sde.N``
    times from T down to ``eps`` the corrector (``n_steps`` steps) and the
    predictor; with ``denoise`` the result is the last predictor mean.  The
    state is float32 [shape] on ``device`` (default ``"cuda"``, which
    raises without a card); ``score_fn`` gets it as it is.  ``prior`` (the
    prior sample) and ``noises`` (``noises[i]``: step i's corrector noises
    and predictor noise, each like the state) are drawn from ``generator``
    unless given, so that a test can feed the ones another implementation
    drew.  An unknown predictor or corrector raises ``KeyError``."""
    pred, corr = get_predictor(predictor), get_corrector(corrector)
    dev = resolve_device(device)
    n_corr = n_steps if corrector != "none" else 0
    timesteps = torch.linspace(sde.T, eps, sde.N, dtype=torch.float64).to(
        torch.float32)

    @torch.no_grad()
    def sampler(generator: torch.Generator | None = None, *, prior=None,
                noises=None):
        def normal():
            return torch.randn(shape, generator=generator, device=dev)

        x = (sde.prior_sampling(shape, generator, dev) if prior is None
             else torch.as_tensor(prior, dtype=torch.float32, device=dev))
        x_mean = x
        for i, t in enumerate(timesteps.to(dev)):
            zc, zp = (([normal() for _ in range(n_corr)], normal())
                      if noises is None else noises[i])
            tb = t.expand(shape[0])
            x, _ = corr(sde, score_fn, x, tb, zc, snr=snr)
            x, x_mean = pred(sde, score_fn, x, tb, zp)
        return (x_mean if denoise else x), sde.N * (n_steps + 1)

    return sampler


# -- probability-flow ODE sampler (JAX pc.py:199-229)


def get_ode_sampler(sde: SDE, score_fn, shape, *, rtol: float = 1e-5,
                    atol: float = 1e-5, eps: float = 1e-3,
                    denoise: bool = False, device="cuda"):
    """Returns ``sampler(generator=None, x_init=None) -> (x, nfe)``:
    adaptive RK45 (:func:`.rk45.rk45_integrate`) over the probability-flow
    ODE from ``sde.T`` to ``eps``, from ``x_init`` or a prior sample drawn
    from ``generator``; with ``denoise`` one reverse-diffusion denoising
    step at ``eps`` after it (one more model call).  The state is float32
    on ``device`` unless ``x_init`` gives another type."""
    from .rk45 import rk45_integrate

    dev = resolve_device(device)
    rsde = sde.reverse(score_fn, probability_flow=True)

    def ode_fn(x, t):
        tb = torch.full((shape[0],), float(t), dtype=x.dtype, device=x.device)
        return rsde.sde(x, tb)[0]

    @torch.no_grad()
    def sampler(generator: torch.Generator | None = None, x_init=None):
        if x_init is None:
            x_init = sde.prior_sampling(shape, generator, dev)
        x, nfe = rk45_integrate(ode_fn, x_init, sde.T, eps, rtol=rtol,
                                atol=atol)
        if denoise:
            tb = torch.full((shape[0],), eps, dtype=x.dtype, device=x.device)
            f, _ = sde.reverse(score_fn).discretize(x, tb)
            x = x - f
            nfe += 1
        return x, nfe

    return sampler
