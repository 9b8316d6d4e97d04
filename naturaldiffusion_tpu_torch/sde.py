"""SDEs in PyTorch (port of ``naturaldiffusion_tpu/sde.py``): the ``SDE``
base, ``VPSDE``, ``SubVPSDE``, ``VESDE`` and ``get_score_fn``.

Methods take a time tensor ``t [B]`` and work in its type and on its
device; per-sample scalars broadcast over the trailing dims of ``x``.  The
discrete tables (the DDPM betas and their cumulative product) are built in
float64 on ``t``'s device and read at the step's index, then cast to
``t``'s type.
"""

from __future__ import annotations

import abc
import dataclasses
import math

import torch


def _bcast(a, x):
    """Broadcast per-batch scalar ``a`` over the trailing dims of ``x``."""
    return a.reshape(a.shape + (1,) * (x.dim() - a.dim()))


class SDE(abc.ABC):
    """dx = f(x,t) dt + g(t) dw on t in [0, T] (JAX ``sde.py:19``)."""

    N: int
    T: float = 1.0

    @abc.abstractmethod
    def sde(self, x, t):
        """(drift, diffusion)."""

    @abc.abstractmethod
    def marginal_prob(self, x, t):
        """(mean, std) of p_t(x(t) | x(0))."""

    @abc.abstractmethod
    def prior_sampling(self, shape, generator, device): ...

    @abc.abstractmethod
    def prior_logp(self, z):
        """Log-density of the prior at ``z`` [B, ...], per sample."""

    def discretize(self, x, t):
        """Euler-Maruyama one-step coefficients (f_i, G_i) with
        x_{i+1} = x_i + f_i + G_i z (JAX ``sde.py:39``)."""
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn, probability_flow: bool = False):
        """The reverse-time SDE, or its probability-flow ODE (JAX
        ``sde.py:46``)."""
        fwd_sde, fwd_disc = self.sde, self.discretize
        factor = 0.5 if probability_flow else 1.0

        class RSDE:
            def sde(self, x, t):
                drift, diffusion = fwd_sde(x, t)
                score = score_fn(x, t)
                drift = drift - _bcast(torch.atleast_1d(diffusion) ** 2,
                                       x) * score * factor
                if probability_flow:
                    diffusion = torch.zeros_like(diffusion)
                return drift, diffusion

            def discretize(self, x, t):
                f, G = fwd_disc(x, t)
                rev_f = f - _bcast(torch.atleast_1d(G) ** 2, x) \
                    * score_fn(x, t) * factor
                return rev_f, torch.zeros_like(G) if probability_flow else G

        return RSDE()


def _step_index(sde, t):
    """The discrete step of time ``t``: ``int(t (N - 1) / T)``, computed in
    ``t``'s type as JAX's ``astype(int32)`` truncates it."""
    return (t * (sde.N - 1) / sde.T).long()


def _vp_betas(sde, device):
    """The N DDPM betas ``linspace(beta_min / N, beta_max / N, N)``."""
    return torch.linspace(sde.beta_min / sde.N, sde.beta_max / sde.N, sde.N,
                          dtype=torch.float64, device=device)


def _std_normal_logp(z):
    d = math.prod(z.shape[1:])
    return (-d / 2.0 * math.log(2 * math.pi)
            - torch.sum(z.reshape(z.shape[0], -1) ** 2, -1) / 2.0)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    """dx = -1/2 beta(t) x dt + sqrt(beta(t)) dw (JAX ``sde.py:80``)."""
    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t):
        beta_t = self.beta(t)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t)

    def log_mean_coeff(self, t):
        return (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
                - 0.5 * t * self.beta_min)

    def marginal_prob(self, x, t):
        lmc = self.log_mean_coeff(t)
        return (_bcast(torch.exp(lmc), x) * x,
                torch.sqrt(1.0 - torch.exp(2.0 * lmc)))

    def prior_sampling(self, shape, generator, device):
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z):
        return _std_normal_logp(z)

    def discretize(self, x, t):
        """The DDPM discretization (JAX ``sde.py:108``)."""
        beta = _vp_betas(self, t.device)[_step_index(self, t)].to(t.dtype)
        f = _bcast(torch.sqrt(1.0 - beta), x) * x - x
        return f, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(SDE):
    """VP drift with shrunken diffusion (JAX ``sde.py:121``); its
    ``marginal_prob`` std is ``1 - exp(2 log_mean_coeff)``, as the
    reference's."""
    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        discount = 1.0 - torch.exp(-2.0 * self.beta_min * t
                                   - (self.beta_max - self.beta_min) * t ** 2)
        return -0.5 * _bcast(beta_t, x) * x, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        lmc = (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
               - 0.5 * t * self.beta_min)
        return _bcast(torch.exp(lmc), x) * x, 1.0 - torch.exp(2.0 * lmc)

    def prior_sampling(self, shape, generator, device):
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z):
        return _std_normal_logp(z)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """dx = sigma_min (sigma_max/sigma_min)^t sqrt(2 log(smax/smin)) dw
    (JAX ``sde.py:149``)."""
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000

    def sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sde(self, x, t):
        diffusion = self.sigma(t) * math.sqrt(
            2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma(t)

    def prior_sampling(self, shape, generator, device):
        return torch.randn(shape, generator=generator,
                           device=device) * self.sigma_max

    def prior_logp(self, z):
        d = math.prod(z.shape[1:])
        return (-d / 2.0 * math.log(2 * math.pi * self.sigma_max ** 2)
                - torch.sum(z.reshape(z.shape[0], -1) ** 2, -1)
                / (2.0 * self.sigma_max ** 2))

    def step_sigmas(self, t):
        """The SMLD table's sigma at the step of ``t`` and at the step
        before it (0 at the first step)."""
        idx = _step_index(self, t)
        sigmas = torch.exp(torch.linspace(
            math.log(self.sigma_min), math.log(self.sigma_max), self.N,
            dtype=t.dtype, device=t.device))
        sigma = sigmas[idx]
        adj = torch.where(idx == 0, torch.zeros_like(sigma),
                          sigmas[(idx - 1).clamp(min=0)])
        return sigma, adj

    def discretize(self, x, t):
        """SMLD ancestral discretization (JAX ``sde.py:177``)."""
        sigma, adj = self.step_sigmas(t)
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adj ** 2)


def get_score_fn(sde: SDE, apply_fn, *, continuous: bool = True):
    """Wrap a ``(x, label)`` denoiser into ``score(x, t)`` (JAX
    ``sde.py:187``), with the label conventions of the reference's
    ``models/utils.py:129-180``:

    * VP / sub-VP continuous: label ``t * 999``, score ``-eps / std``;
    * VP / sub-VP discrete: label ``t * (N - 1)``, score
      ``-eps / sqrt(1 - abar[label])`` from the DDPM table;
    * VE continuous: the label is the marginal std and the model's output
      is the score; VE discrete: the label is the rounded timestep index
      ``round((T - t) (N - 1))``."""
    if isinstance(sde, (VPSDE, SubVPSDE)):
        if continuous:
            def score_fn(x, t):
                eps = apply_fn(x, t * 999)
                std = sde.marginal_prob(torch.zeros_like(t), t)[1]
                return -eps / _bcast(std, x)
        else:
            def score_fn(x, t):
                labels = t * (sde.N - 1)
                eps = apply_fn(x, labels)
                abar = torch.cumprod(1.0 - _vp_betas(sde, t.device), 0)
                std = torch.sqrt(1.0 - abar[labels.long()]).to(t.dtype)
                return -eps / _bcast(std, x)
        return score_fn
    if not isinstance(sde, VESDE):
        raise NotImplementedError(type(sde))

    def score_fn(x, t):
        if continuous:
            labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
        else:
            labels = torch.round((sde.T - t) * (sde.N - 1))
        return apply_fn(x, labels)
    return score_fn
