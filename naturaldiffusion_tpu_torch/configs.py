"""Config presets of the port (the VE NCSN++ part of
``naturaldiffusion_tpu/configs.py``): ``get_config(name)`` lifts an entry of
:mod:`.configs_zoo` into typed model, SDE and sampling configs, and
:func:`get_sde` builds its SDE."""

from __future__ import annotations

import dataclasses

from .configs_zoo import ZOO
from .models.ncsnpp import NCSNppConfig
from .sde import VESDE


@dataclasses.dataclass(frozen=True)
class SDEConfig:
    sde: str = "vesde"
    continuous: bool = True
    sigma_min: float = 0.01
    sigma_max: float = 50.0
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
    model: NCSNppConfig
    sde: SDEConfig
    sampling: SamplingConfig


CONFIGS = {name: ExperimentConfig(name=name,
                                  model=NCSNppConfig(**e["model"]),
                                  sde=SDEConfig(**e["sde"]),
                                  sampling=SamplingConfig(**e["sampling"]))
           for name, e in ZOO.items()}


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"{name!r} is not ported yet (ported: "
                       f"{sorted(CONFIGS)})")
    return CONFIGS[name]


def get_sde(cfg: ExperimentConfig) -> VESDE:
    """The config's SDE (VE only, as the ported entries)."""
    if cfg.sde.sde != "vesde":
        raise NotImplementedError(f"sde={cfg.sde.sde!r} is not ported yet")
    return VESDE(sigma_min=cfg.sde.sigma_min, sigma_max=cfg.sde.sigma_max,
                 N=cfg.sde.num_scales)
