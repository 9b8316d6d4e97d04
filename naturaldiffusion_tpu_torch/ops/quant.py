"""Weight quantization (the part of ``naturaldiffusion_tpu/ops/quant.py``
that the DiT's ``NATDIFF_QUANT=w8`` path uses).

The int8 conv paths of the JAX package (``conv3x3_int8``, ``conv1x1_int8``,
``quant_enabled``'s conv modes) are not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch

_QMAX = 127.0


def quantize_weight(w: torch.Tensor, axis: int = -1):
    """Static symmetric per-output-channel quantization.

    ``w``: [..., C_out] kernel.  Returns ``(w_i8, s_w)`` with ``s_w`` f32
    kept broadcastable against ``w`` (the reduced axes of size 1):
    ``s_w = max(max|w|, 1e-30) / 127`` over all axes but ``axis``, and
    ``w_i8 = clip(round(w / s_w), -127, 127)`` with round-half-to-even, as
    ``jnp.round`` does; both in float32."""
    ax = axis % w.dim()
    red = tuple(i for i in range(w.dim()) if i != ax)
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=red, keepdim=True) if red else wf.abs()
    s_w = amax.clamp_min(1e-30) / _QMAX
    w_i8 = torch.clamp(torch.round(wf / s_w), -_QMAX, _QMAX).to(torch.int8)
    return w_i8, s_w
