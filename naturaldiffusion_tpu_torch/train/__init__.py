"""Training (port of ``naturaldiffusion_tpu/train``): losses, the
optimizer, EMA, the train state and step, checkpoints."""

from .losses import (make_optimizer, sde_loss_fn, smld_loss_fn, ddpm_loss_fn)
from .ema import EMA
from .state import TrainState, make_train_step

__all__ = ["make_optimizer", "sde_loss_fn", "smld_loss_fn", "ddpm_loss_fn",
           "EMA", "TrainState", "make_train_step"]
