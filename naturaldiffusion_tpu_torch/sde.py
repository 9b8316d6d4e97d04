"""SDEs in PyTorch (port of the parts of ``naturaldiffusion_tpu/sde.py``
that VE sampling reaches: the ``SDE`` base, ``VESDE`` and
``get_score_fn``).

Methods take a time tensor ``t [B]`` and work in its type and on its
device; per-sample scalars broadcast over the trailing dims of ``x``.
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

    def discretize(self, x, t):
        """SMLD ancestral discretization (JAX ``sde.py:177``)."""
        idx = (t * (self.N - 1) / self.T).long()
        sigmas = torch.exp(torch.linspace(
            math.log(self.sigma_min), math.log(self.sigma_max), self.N,
            dtype=t.dtype, device=t.device))
        sigma = sigmas[idx]
        adj = torch.where(idx == 0, torch.zeros_like(sigma),
                          sigmas[(idx - 1).clamp(min=0)])
        return torch.zeros_like(x), torch.sqrt(sigma ** 2 - adj ** 2)


def get_score_fn(sde: SDE, apply_fn, *, continuous: bool = True):
    """Wrap a ``(x, label)`` denoiser into ``score(x, t)`` (JAX
    ``sde.py:187``).  VE continuous: the label is the marginal std and the
    model's output is the score; VE discrete: the label is the rounded
    timestep index ``round((T - t) (N - 1))``."""
    if not isinstance(sde, VESDE):
        raise NotImplementedError(
            f"get_score_fn for {type(sde).__name__} is not ported yet "
            "(ROADMAP.md, Queue A, slice 2: samplers)")

    def score_fn(x, t):
        if continuous:
            labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
        else:
            labels = torch.round((sde.T - t) * (sde.N - 1))
        return apply_fn(x, labels)
    return score_fn
