"""GroupNorm maths in plain PyTorch (port of ``naturaldiffusion_tpu/ops/
group_norm.py``).

Statistics and the affine in float32 with the fast-variance formula
(``E[x^2] - E[x]^2``), output cast to ``x``'s type.  On the fused-resblock
path a GroupNorm never runs as a pass of its own: :func:`gn_affine_coeffs`
collapses it into per-(sample, channel) scalars that the conv kernel's
prologue applies (``ops.conv3x3.conv3x3_gn``).  The standalone GroupNorms
(the resampling blocks' ``GroupNorm_0``, attention, the output head) stay
plain PyTorch here, as the JAX default leaves them to XLA; the GroupNorm
kernel (``_gn_body``) is the next slice's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _apply_act(y, act):
    if act is None:
        return y
    if act == "silu":
        return F.silu(y)
    raise ValueError(f"unsupported act: {act}")


def group_norm_reference(x, scale, bias, num_groups: int, eps: float = 1e-6,
                         act: str | None = None, extra_bias=None):
    """``x`` [B, H, W, C] -> GroupNorm(x + extra_bias) (+ act), x's type.

    ``extra_bias``: optional [B, C] (or [1, C]) added before the
    statistics."""
    b, h, w, c = x.shape
    gs = c // num_groups
    xf = x.to(torch.float32)
    if extra_bias is not None:
        xf = xf + extra_bias.to(torch.float32)[:, None, None, :]
    g = xf.reshape(b, h, w, num_groups, gs)
    mu = g.mean(dim=(1, 2, 4), keepdim=True)
    var = (g * g).mean(dim=(1, 2, 4), keepdim=True) - mu * mu
    yn = (g - mu) * torch.rsqrt(var + eps)
    y = (yn.reshape(b, h, w, c) * scale.to(torch.float32)
         + bias.to(torch.float32))
    return _apply_act(y, act).to(x.dtype)


def gn_channel_sums(x):
    """Per-(sample, channel) spatial sums ``(s1, s2)``, float32 [B, C]."""
    xf = x.to(torch.float32)
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def gn_affine_coeffs(s1, s2, n_spatial: int, scale, bias, num_groups: int,
                     eps: float = 1e-6, extra_bias=None):
    """Collapse GroupNorm(x + extra_bias) into ``(w_c, b_c)`` float32 [B, C]
    with ``GN(x + tb) == x * w_c + b_c``.

    ``s1``/``s2`` are the channel sums of ``x`` (not of ``x + tb``); the
    bias enters algebraically: ``s1' = s1 + n*tb``, ``s2' = s2 + 2*tb*s1 +
    n*tb**2``, with no pass over the activation."""
    b, c = s1.shape
    gs = c // num_groups
    n = n_spatial * gs
    s1 = s1.to(torch.float32)
    s2 = s2.to(torch.float32)
    if extra_bias is not None:
        tb = extra_bias.to(torch.float32).expand(b, c)
        s2 = s2 + 2.0 * tb * s1 + n_spatial * tb * tb
        s1 = s1 + n_spatial * tb
    sg = s1.reshape(b, num_groups, gs).sum(-1)
    s2g = s2.reshape(b, num_groups, gs).sum(-1)
    mu = sg / n
    var = s2g / n - mu * mu
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(gs, dim=1)
    mu_c = mu.repeat_interleave(gs, dim=1)
    w_c = inv_c * scale.to(torch.float32)
    b_c = bias.to(torch.float32) - mu_c * w_c
    if extra_bias is not None:
        # the prologue applies x*w_c + b_c to the raw x: fold the tb shift
        # in, (x + tb - mu)*inv*scale + bias
        b_c = b_c + tb * w_c
    return w_c, b_c
