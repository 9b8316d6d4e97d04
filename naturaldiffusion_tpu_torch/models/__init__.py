"""Model definitions (NHWC), weight conversion, and the registry of
``naturaldiffusion_tpu/models/__init__.py:18-46`` (itself
``deps/score_sde_pytorch/models/utils.py:24-96``): ``create_model(name,
config)`` builds a model by its family name, the ``model_family`` of a
:func:`..configs.get_config` entry."""

from .ddpm import DDPM, DDPMConfig
from .dit import DIT_CONFIGS, DiT, DiTConfig
from .mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig
from .ncsnpp import NCSNpp, NCSNppConfig
from .ncsnv2 import NCSN, NCSNv2, NCSNv2_128, NCSNv2_256, NCSNv2Config
from .vae import SD3_VAE, SD_VAE, AutoencoderKL, VAEConfig

_MODELS = {
    "ncsnpp": (NCSNpp, NCSNppConfig),
    "ddpm": (DDPM, DDPMConfig),
    "ncsnv2_64": (NCSNv2, NCSNv2Config),
    "ncsnv2_128": (NCSNv2_128, NCSNv2Config),
    "ncsnv2_256": (NCSNv2_256, NCSNv2Config),
    "ncsn": (NCSN, NCSNv2Config),
    "dit": (DiT, DiTConfig),
    "mmdit": (MMDiT, MMDiTConfig),
    "vae": (AutoencoderKL, VAEConfig),
}


def register_model(name: str):
    """Decorator registering a ``(model class, config class)`` pair."""
    def deco(pair):
        _MODELS[name] = pair
        return pair
    return deco


def get_model(name: str):
    """The ``(model class, config class)`` pair of a family."""
    return _MODELS[name]


def create_model(name: str, config=None, *, device="cuda", seed: int = 0,
                 **config_kwargs):
    """The family's model from ``config`` (or its config class built from
    ``config_kwargs``), random weights from ``seed``, on ``device``
    (default ``"cuda"``, which raises without a card)."""
    cls, cfg_cls = get_model(name)
    cfg = config if config is not None else cfg_cls(**config_kwargs)
    return cls(cfg, device=device, seed=seed)


__all__ = ["AutoencoderKL", "DDPM", "DDPMConfig", "DIT_CONFIGS", "DiT",
           "DiTConfig", "MMDiT", "MMDiTConfig", "NCSN", "NCSNpp",
           "NCSNppConfig", "NCSNv2", "NCSNv2Config", "NCSNv2_128",
           "NCSNv2_256", "SD3_MEDIUM", "SD3_VAE", "SD_VAE", "VAEConfig",
           "create_model", "get_model", "register_model"]
