"""Controllable generation: PC inpainting and colorization (port of
``naturaldiffusion_tpu/samplers/controllable.py``, after
``deps/score_sde_pytorch/controllable_generation.py:8-180``), NHWC.

Every step runs the corrector, projects onto the known data, runs the
predictor, then projects its mean and its sample: the masked pixels for
inpainting, the gray-scale channel of an orthonormal color decoupling for
colorization.  The steps are the port's PC predictors and correctors
(``samplers/pc.py``), which take their noises as tensors: the samplers
draw them from a ``torch.Generator``, or take them as given, so that a test
can feed the ones another implementation drew.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sde import SDE, _bcast
from .pc import get_corrector, get_predictor


class DrawnNoises:
    """The noises of each step, drawn from ``generator`` as the step asks:
    ``noises[i]`` is ``(corrector noises (n_corr), predictor noise, z1,
    z2)``, each like the state; ``z1`` feeds the projection after the
    corrector and ``z2`` the projection of the predictor's sample (the JAX
    package's per-step keys ``kc``, ``kp``, ``k1``, ``k2``)."""

    def __init__(self, generator, shape, n_corr: int, device):
        self.generator, self.shape = generator, tuple(shape)
        self.n_corr, self.device = n_corr, device

    def __getitem__(self, i):
        def normal():
            return torch.randn(self.shape, generator=self.generator,
                               device=self.device)
        return ([normal() for _ in range(self.n_corr)], normal(), normal(),
                normal())


def _pc_projected_sampler(sde: SDE, score_fn, project, *, predictor: str,
                          corrector: str, snr: float, n_steps: int,
                          denoise: bool, eps: float):
    """``sampler(x_init, noises)``: for each of ``sde.N`` times from T down
    to ``eps``: corrector -> project -> predictor -> project (mean and
    sample); the last mean with ``denoise``, else the last sample."""
    pred, corr = get_predictor(predictor), get_corrector(corrector)
    timesteps = torch.linspace(sde.T, eps, sde.N, dtype=torch.float64).to(
        torch.float32)

    def sampler(x_init, noises):
        x = x_mean = x_init
        for i, t in enumerate(timesteps.to(x_init.device)):
            zc, zp, z1, z2 = noises[i]
            tb = t.expand(x.shape[0])
            x, _ = corr(sde, score_fn, x, tb, zc, snr=snr)
            x = project(x, tb, z1)
            x, _ = pred(sde, score_fn, x, tb, zp)
            x_mean = project(x, tb, None)
            x = project(x, tb, z2)
        return x_mean if denoise else x

    return sampler


def _n_corr(corrector: str, n_steps: int) -> int:
    get_corrector(corrector)     # an unknown name raises KeyError here
    return n_steps if corrector != "none" else 0


def get_pc_inpainter(sde: SDE, score_fn, *, predictor="reverse_diffusion",
                     corrector="langevin", snr: float = 0.16,
                     n_steps: int = 1, denoise: bool = True,
                     eps: float = 1e-5, inverse_scaler=lambda x: x,
                     device="cuda"):
    """``inpainter(generator, data, mask, *, prior=None, noises=None) ->
    images`` (JAX ``inpainter(key, data, mask)``; reference
    ``controllable_generation.py:8-84``).  ``mask == 1`` marks the known
    pixels; ``data`` and ``mask`` ``[B, H, W, C]``.  The state is float32
    on ``device`` (default ``"cuda"``, which raises without a card).
    ``prior`` (the prior sample) and ``noises`` (indexable by step, as
    :class:`DrawnNoises`) are drawn from ``generator`` unless given."""
    dev = resolve_device(device)
    n_corr = _n_corr(corrector, n_steps)

    @torch.no_grad()
    def inpainter(generator, data, mask, *, prior=None, noises=None):
        data = torch.as_tensor(data, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        if prior is None:
            prior = sde.prior_sampling(data.shape, generator, dev)
        if noises is None:
            noises = DrawnNoises(generator, data.shape, n_corr, dev)
        x0 = data * mask + prior.to(dev) * (1.0 - mask)

        def project(x, tb, z):
            m, std = sde.marginal_prob(data, tb)
            known = m if z is None else m + z * _bcast(
                torch.atleast_1d(std), x)
            return x * (1.0 - mask) + known * mask

        sampler = _pc_projected_sampler(
            sde, score_fn, project, predictor=predictor, corrector=corrector,
            snr=snr, n_steps=n_steps, denoise=denoise, eps=eps)
        return inverse_scaler(sampler(x0, noises))

    return inpainter


# orthonormal color decoupling: channel 0 of the decoupled space is the
# gray-scale average (reference ``controllable_generation.py:105-120``)
_M = np.array([[5.7735014e-01, -8.1649649e-01, 4.7008697e-08],
               [5.7735026e-01, 4.0824834e-01, 7.0710671e-01],
               [5.7735026e-01, 4.0824822e-01, -7.0710683e-01]],
              dtype=np.float32)
_INV_M = np.linalg.inv(_M)


def decouple(x):
    """NHWC ``x`` times M over the channels (the reference's NCHW einsum
    ``'bihw,ij->bjhw'``)."""
    return torch.einsum("bhwi,ij->bhwj", x,
                        torch.as_tensor(_M, dtype=x.dtype, device=x.device))


def couple(x):
    return torch.einsum("bhwi,ij->bhwj", x, torch.as_tensor(
        _INV_M, dtype=x.dtype, device=x.device))


def get_pc_colorizer(sde: SDE, score_fn, *, predictor="reverse_diffusion",
                     corrector="langevin", snr: float = 0.16,
                     n_steps: int = 1, denoise: bool = True,
                     eps: float = 1e-5, inverse_scaler=lambda x: x,
                     device="cuda"):
    """``colorizer(generator, gray, *, prior=None, noises=None) -> images``
    (JAX ``colorizer(key, gray_img)``; reference
    ``controllable_generation.py:87-180``).  ``gray`` ``[B, H, W, 3]`` has
    equal RGB channels; the decoupled channel 0 is kept.  Otherwise as
    :func:`get_pc_inpainter`."""
    dev = resolve_device(device)
    n_corr = _n_corr(corrector, n_steps)

    @torch.no_grad()
    def colorizer(generator, gray, *, prior=None, noises=None):
        gray = torch.as_tensor(gray, dtype=torch.float32, device=dev)
        mask = torch.cat([torch.ones_like(gray[..., :1]),
                          torch.zeros_like(gray[..., 1:])], dim=-1)
        if prior is None:
            prior = sde.prior_sampling(gray.shape, generator, dev)
        if noises is None:
            noises = DrawnNoises(generator, gray.shape, n_corr, dev)
        gray_d = decouple(gray)
        x0 = couple(gray_d * mask + decouple(prior.to(dev)) * (1.0 - mask))

        def project(x, tb, z):
            m, std = sde.marginal_prob(gray_d, tb)
            known = m if z is None else m + z * _bcast(
                torch.atleast_1d(std), x)
            return couple(decouple(x) * (1.0 - mask) + known * mask)

        sampler = _pc_projected_sampler(
            sde, score_fn, project, predictor=predictor, corrector=corrector,
            snr=snr, n_steps=n_steps, denoise=denoise, eps=eps)
        return inverse_scaler(sampler(x0, noises))

    return colorizer
