"""Name -> deriver registry for the derivations ported so far.

The JAX package's registry (``naturaldiffusion_tpu/coeffs/registry.py``)
holds every sampler family; the port grows this table slice by slice.  A
name that is not ported yet raises ``KeyError`` listing what is.
"""

from __future__ import annotations

from typing import Callable

from . import ddpm_ddim
from .matrix import CoeffMatrix

DERIVERS: dict[str, Callable[[int], CoeffMatrix]] = {
    "ddpm": ddpm_ddim.derive_ddpm,
    "ddim": ddpm_ddim.derive_ddim,
}


def derive(name: str, num_step: int) -> CoeffMatrix:
    """Derive + NaN-guard: a poisoned schedule raises FloatingPointError
    here instead of silently emitting NaN matrices."""
    if name not in DERIVERS:
        raise KeyError(f"derivation {name!r} is not ported yet; ported: "
                       f"{sorted(DERIVERS)} (the other samplers come with "
                       f"the samplers slice)")
    return DERIVERS[name](num_step).check_finite(
        context=f"{name}({num_step})")
