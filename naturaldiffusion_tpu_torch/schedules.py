"""Discrete DDPM/DDIM noise-schedule math (host-side, float64 numpy).

The part of ``naturaldiffusion_tpu/schedules.py`` that the ported
derivations (:mod:`naturaldiffusion_tpu_torch.coeffs.ddpm_ddim`) use, copied
so the port never imports the JAX package.  The continuous VP-SDE, DEIS and
flow schedules come with the samplers that need them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Evenly-respaced subset of ``range(num_timesteps)``.

    Same respacing semantics as the improved-diffusion scheme the reference
    uses (``src/AnalyzeDDPMDDIM.py:23-73``): split the original process into
    sections (``"10"`` or ``"5,5"``) and stride each with fractional steps.
    """
    if isinstance(section_counts, str):
        section_counts = [int(x) for x in section_counts.split(",")]

    per, extra = divmod(num_timesteps, len(section_counts))
    taken: list[int] = []
    start = 0
    for i, count in enumerate(section_counts):
        size = per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot take {count} steps from a section of {size}")
        stride = (size - 1) / (count - 1) if count > 1 else 1.0
        pos = 0.0
        for _ in range(count):
            taken.append(start + round(pos))
            pos += stride
        start += size
    return set(taken)


def linear_betas(n: int = 1000, lo: float = 1e-4, hi: float = 0.02) -> np.ndarray:
    return np.linspace(lo, hi, n, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DiscreteVP:
    """A discrete VP diffusion over an (optionally respaced) timestep grid.

    ``timesteps[i]`` is the original-process index of grid node ``i``
    (ascending).  ``alphas_bar`` are the marginal signal**2 coefficients at
    those nodes (reference: ``src/AnalyzeDDPMDDIM.py:76-123`` and
    ``:250-294``).
    """

    timesteps: np.ndarray          # [n] int, ascending
    alphas_bar: np.ndarray         # [n] cumulative alpha-bar at each node

    @classmethod
    def create(cls, num_step: int | None = None, n_train: int = 1000,
               betas: np.ndarray | None = None) -> "DiscreteVP":
        if betas is None:
            betas = linear_betas(n_train)
        alphas_bar = np.cumprod(1.0 - betas)
        if num_step is None:
            idx = np.arange(len(betas))
        else:
            idx = np.array(sorted(space_timesteps(len(betas), str(int(num_step)))))
        return cls(timesteps=idx, alphas_bar=alphas_bar[idx])

    @property
    def alphas(self) -> np.ndarray:
        """Per-step alpha between consecutive grid nodes."""
        prev = np.append(1.0, self.alphas_bar[:-1])
        return self.alphas_bar / prev

    @property
    def betas(self) -> np.ndarray:
        return 1.0 - self.alphas

    @property
    def alphas_bar_prev(self) -> np.ndarray:
        return np.append(1.0, self.alphas_bar[:-1])

    # DDPM ancestral (posterior) coefficients ------------------------------

    @property
    def posterior_var(self) -> np.ndarray:
        return self.betas * (1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar)

    @property
    def posterior_log_var(self) -> np.ndarray:
        # First entry clamped as in the reference (src/AnalyzeDDPMDDIM.py:83)
        return np.log(np.append(1e-5, self.posterior_var[1:]))

    @property
    def posterior_std(self) -> np.ndarray:
        return np.sqrt(np.exp(self.posterior_log_var))

    @property
    def ddpm_coeff_x0(self) -> np.ndarray:
        """Posterior-mean weight on predicted x0."""
        return np.sqrt(self.alphas_bar_prev) * self.betas / (1.0 - self.alphas_bar)

    @property
    def ddpm_coeff_xt(self) -> np.ndarray:
        """Posterior-mean weight on x_t."""
        return np.sqrt(self.alphas) * (1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar)

    # DDIM (eta=0) update coefficients -------------------------------------

    @property
    def ddim_coeff_xt(self) -> np.ndarray:
        return np.sqrt((1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar))

    @property
    def ddim_coeff_x0(self) -> np.ndarray:
        return np.sqrt(self.alphas_bar_prev) - self.ddim_coeff_xt * np.sqrt(self.alphas_bar)
