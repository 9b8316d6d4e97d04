"""Guidance combinators: wrap a conditional network into a ``(x, t) ->
pred`` denoiser for the NI engine (port of ``naturaldiffusion_tpu/engine/
guidance.py``).

Reference CFG sites: ``src/ValidateNaturalInference.py:185-195`` (DiT
duplicates the batch for cond+uncond and fuses), the DiT quirk
(``deps/DiT/models.py:255-272``), and the SD3 two-pass CFG at
``src/SD3NaturalInference.py:210-217``.
"""

from __future__ import annotations

from typing import Callable

import torch


def classifier_free(model_fn: Callable, cond, uncond, scale: float,
                    *, split_channels: int | None = None) -> Callable:
    """Classifier-free guidance ``u + s * (c - u)``, both passes fused into
    one batch-doubled call of ``model_fn(x, t, conditioning)``.

    ``split_channels``: if set, only the first ``split_channels`` entries of
    axis 1 are guided and the rest come from the conditional branch, as in
    the JAX package (which slices axis 1 too; for an NHWC output that is
    the row axis, see ROADMAP.md section C)."""
    def denoise(x, t):
        out = model_fn(torch.cat([x, x]), t, torch.cat([cond, uncond]))
        c_out, u_out = torch.chunk(out, 2, dim=0)
        if split_channels is None:
            return u_out + scale * (c_out - u_out)
        guided = u_out[:, :split_channels] + scale * (
            c_out[:, :split_channels] - u_out[:, :split_channels])
        return torch.cat([guided, c_out[:, split_channels:]], dim=1)
    return denoise


def classifier_free_two_pass(model_fn: Callable, cond, uncond,
                             scale: float) -> Callable:
    """CFG with two sequential passes (half the peak activation memory;
    the SD3 reference loop ``src/SD3NaturalInference.py:210-217``)."""
    def denoise(x, t):
        c_out = model_fn(x, t, cond)
        u_out = model_fn(x, t, uncond)
        return u_out + scale * (c_out - u_out)
    return denoise


def unconditional(model_fn: Callable) -> Callable:
    def denoise(x, t):
        return model_fn(x, t)
    return denoise
