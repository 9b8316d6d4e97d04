"""Exponential moving average of the parameters (port of
``naturaldiffusion_tpu/train/ema.py``; the reference's
``deps/score_sde_pytorch/models/ema.py:10-97``).

The shadow starts as a copy of the parameters.  Each update counts
``n += 1``, takes ``decay = min(decay, (1 + n) / (10 + n))`` when ``warmup``
(in float32, as JAX computes it) and moves the shadow in place:
``s <- s - (1 - decay) (s - p)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EMA:
    shadow: list            # tensors, in the order of the parameters
    decay: float = 0.9999
    num_updates: int = 0
    warmup: bool = True     # the reference's num_updates decay ramp

    @classmethod
    def create(cls, params, decay: float = 0.9999, warmup: bool = True):
        return cls(shadow=[p.detach().clone() for p in params], decay=decay,
                   num_updates=0, warmup=warmup)

    def one_minus_decay(self, n: int) -> float:
        """``1 - decay`` of update ``n`` in float32."""
        f32 = np.float32
        decay = f32(self.decay)
        if self.warmup:
            decay = min(decay, (f32(1.0) + f32(n)) / (f32(10.0) + f32(n)))
        return float(f32(1.0) - decay)

    @torch.no_grad()
    def update(self, params) -> "EMA":
        """One update towards ``params``, in place; returns self."""
        n = self.num_updates + 1
        diff = torch._foreach_sub(self.shadow, list(params))
        torch._foreach_mul_(diff, self.one_minus_decay(n))
        torch._foreach_sub_(self.shadow, diff)
        self.num_updates = n
        return self
