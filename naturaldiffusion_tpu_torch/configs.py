"""Config presets of the port (``naturaldiffusion_tpu/configs.py``):
``get_config(name)`` lifts an entry of :mod:`.configs_zoo` into typed model,
SDE and sampling configs (the model's config class is the one the model
registry holds for the entry's ``model_family``, JAX ``configs.py:79-104``),
and :func:`get_sde` builds its SDE (VE, VP or sub-VP).
``models.create_model(cfg.model_family, cfg.model)`` builds the model."""

from __future__ import annotations

import dataclasses

from .configs_zoo import ZOO
from .models import get_model
from .sde import SDE, SubVPSDE, VESDE, VPSDE


@dataclasses.dataclass(frozen=True)
class SDEConfig:
    sde: str = "vesde"
    continuous: bool = True
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    beta_min: float = 0.1
    beta_max: float = 20.0
    num_scales: int = 1000


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    method: str = "pc"
    predictor: str = "euler_maruyama"
    corrector: str = "none"
    snr: float = 0.16
    n_steps_each: int = 1
    noise_removal: bool = True
    probability_flow: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model_family: str           # a registry name (models.create_model)
    model: object
    sde: SDEConfig
    sampling: SamplingConfig


CONFIGS = {name: ExperimentConfig(
    name=name, model_family=e["family"],
    model=get_model(e["family"])[1](**e["model"]),
    sde=SDEConfig(**e["sde"]), sampling=SamplingConfig(**e["sampling"]))
    for name, e in ZOO.items()}


def get_config(name: str) -> ExperimentConfig:
    return CONFIGS[name]


def get_sde(cfg: ExperimentConfig) -> SDE:
    """The config's SDE, with its N = ``num_scales``."""
    s = cfg.sde
    if s.sde == "vesde":
        return VESDE(sigma_min=s.sigma_min, sigma_max=s.sigma_max,
                     N=s.num_scales)
    if s.sde in ("vpsde", "subvpsde"):
        cls = VPSDE if s.sde == "vpsde" else SubVPSDE
        return cls(beta_min=s.beta_min, beta_max=s.beta_max, N=s.num_scales)
    raise ValueError(f"unknown sde {s.sde!r}")
