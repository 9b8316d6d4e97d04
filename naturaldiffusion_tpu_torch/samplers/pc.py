"""Predictor-corrector sampling (port of the parts of
``naturaldiffusion_tpu/samplers/pc.py`` that VE sampling reaches:
``reverse_diffusion``, ``langevin``, the ``none`` predictor and corrector,
and ``get_pc_sampler``).

Step functions take their Gaussian noise as tensors, so a test can feed
them the numbers another implementation drew; the sampler draws them from
a ``torch.Generator`` on the state's device.  The time loop is a Python
loop (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..sde import SDE, VESDE, _bcast


def reverse_diffusion(sde: SDE, score_fn, x, t, z):
    """One reverse-diffusion predictor step (JAX ``pc.py:63``), noise
    ``z`` like x.  Returns ``(x, x_mean)``."""
    f, G = sde.reverse(score_fn).discretize(x, t)
    x_mean = x - f
    return x_mean + _bcast(torch.atleast_1d(G), x) * z, x_mean


def none_predictor(sde, score_fn, x, t, z):
    return x, x


def langevin(sde: SDE, score_fn, x, t, noises, *, snr: float):
    """Langevin corrector (JAX ``pc.py:107``), one step per entry of
    ``noises`` (each like x).  Returns ``(x, x)``."""
    if not isinstance(sde, VESDE):
        raise NotImplementedError(
            f"langevin for {type(sde).__name__} is not ported yet "
            "(ROADMAP.md, Queue A, slice 2: samplers)")
    for noise in noises:
        grad = score_fn(x, t)
        gn = torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1),
                                      dim=-1).mean()
        nn_ = torch.linalg.vector_norm(noise.reshape(noise.shape[0], -1),
                                       dim=-1).mean()
        step = (snr * nn_ / gn) ** 2 * 2    # VE: alpha = 1
        x_mean = x + _bcast(step, x) * grad
        x = x_mean + _bcast(torch.sqrt(step * 2), x) * noise
    return x, x


def none_corrector(sde, score_fn, x, t, noises, *, snr: float = 0.0):
    return x, x


_PREDICTORS = {"reverse_diffusion": reverse_diffusion, "none": none_predictor}
_CORRECTORS = {"langevin": langevin, "none": none_corrector}


def get_pc_sampler(sde: SDE, score_fn, shape, *, predictor="reverse_diffusion",
                   corrector="none", snr: float = 0.16, n_steps: int = 1,
                   denoise: bool = True, eps: float = 1e-3, device="cuda"):
    """Returns ``sampler(generator) -> (x, nfe)`` (JAX ``pc.py:167``): a
    prior sample, then for each of ``sde.N`` times from T down to ``eps``
    the corrector (``n_steps`` Langevin steps) and the predictor; with
    ``denoise`` the result is the last predictor mean.  The state is
    float32 [shape] on ``device`` (default ``"cuda"``, which raises without
    a card); ``score_fn`` gets it as it is."""
    for name, table in ((predictor, _PREDICTORS), (corrector, _CORRECTORS)):
        if name not in table:
            raise NotImplementedError(
                f"{name!r} is not ported yet (ported: {sorted(table)}; "
                "ROADMAP.md, Queue A, slice 2: samplers)")
    pred, corr = _PREDICTORS[predictor], _CORRECTORS[corrector]
    dev = resolve_device(device)
    n_corr = n_steps if corrector != "none" else 0
    timesteps = torch.linspace(sde.T, eps, sde.N, dtype=torch.float64).to(
        torch.float32)

    @torch.no_grad()
    def sampler(generator: torch.Generator):
        def normal():
            return torch.randn(shape, generator=generator, device=dev)

        x = sde.prior_sampling(shape, generator, dev)
        x_mean = x
        for t in timesteps.to(dev):
            tb = t.expand(shape[0])
            x, _ = corr(sde, score_fn, x, tb, [normal() for _ in
                                                range(n_corr)], snr=snr)
            x, x_mean = pred(sde, score_fn, x, tb, normal())
        return (x_mean if denoise else x), sde.N * (n_steps + 1)

    return sampler
