"""GroupNorm (port of ``naturaldiffusion_tpu/ops/group_norm.py``).

* :func:`fused_group_norm` -- the standalone GroupNorm, kernel K6
  (``_gn_body`` via ``group_norm_pallas``, ``:76``/``:126``) behind the
  dispatcher of the same name (``:277``): ``GN(x + extra_bias)``, float32
  statistics with the fast variance ``E[x^2] - E[x]^2``, the affine, an
  optional SiLU, output in x's type.  A CUDA tensor takes the kernel
  (``csrc/group_norm.cu``) at every shape: the JAX gate ``_eligible``
  (``:164``) is a TPU VMEM budget, and the XLA route it leaves the other
  shapes to computes the same function.  A CPU tensor takes
  :func:`fused_group_norm_reference`.
* :func:`gn_channel_sums` / :func:`gn_affine_coeffs` -- the GroupNorm
  collapsed to per-(sample, channel) scalars, for the fused-resblock
  conv's prologue (``ops.conv3x3.conv3x3_gn``) and for K6's plain version.
* :func:`group_norm_reference` -- the JAX package's plain twin (the
  ``(B, H, W, G, gs)`` reduction), kept as the oracle of the tests.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# natdiff_group_norm(dtype, x, scale, bias, tb, tb_rows, silu, y, s1, s2, B,
# HW, C, group_size, eps, stream)
_GN_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])


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


def fused_group_norm_reference(x, scale, bias, num_groups: int,
                               eps: float = 1e-6, act: str | None = None,
                               extra_bias=None):
    """Plain version of kernel K6, in its arithmetic: the channel sums of
    x, the group fold with ``extra_bias`` entering algebraically
    (:func:`gn_affine_coeffs`), then ``x * w_c + b_c`` in float32, SiLU as
    ``y / (1 + exp(-y))``, output in x's type."""
    s1, s2 = gn_channel_sums(x)
    w_c, b_c = gn_affine_coeffs(s1, s2, x.shape[1] * x.shape[2], scale, bias,
                                num_groups, eps=eps, extra_bias=extra_bias)
    y = x.to(torch.float32) * w_c[:, None, None, :] + b_c[:, None, None, :]
    if act == "silu":
        y = y / (1.0 + torch.exp(-y))
    elif act is not None:
        raise ValueError(f"unsupported act: {act}")
    return y.to(x.dtype)


def _check(x, scale, bias, num_groups, act, extra_bias):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, _, _, c = x.shape
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} "
                         f"groups")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if extra_bias is not None and (
            extra_bias.dim() != 2 or extra_bias.shape[1] != c
            or extra_bias.shape[0] not in (1, b)):
        raise ValueError(f"extra_bias {tuple(extra_bias.shape)} must be "
                         f"[{b}, {c}] or [1, {c}]")
    if act not in (None, "silu"):
        raise ValueError(f"unsupported act: {act}")
    ts = [t for t in (x, scale, bias, extra_bias) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("tensors on several devices")


def fused_group_norm(x, scale, bias, num_groups: int, eps: float = 1e-6,
                     act: str | None = None, extra_bias=None):
    """``GroupNorm(x + extra_bias)`` (+ SiLU) over ``x [B, H, W, C]``,
    output in x's type.  ``extra_bias``: optional ``[B, C]`` or ``[1, C]``
    (broadcast over the batch), added before the statistics.  A CPU tensor
    takes :func:`fused_group_norm_reference`; a CUDA tensor takes kernel
    K6 (x float32 or bfloat16) or raises."""
    _check(x, scale, bias, num_groups, act, extra_bias)
    if x.device.type == "cpu":
        return fused_group_norm_reference(x, scale, bias, num_groups, eps=eps,
                                          act=act, extra_bias=extra_bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the GroupNorm kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    bsz, hh, ww, c = x.shape
    if bsz * hh * ww * c >= 2 ** 31 or bsz > 65535:
        raise ValueError("x too large for the GroupNorm kernel's indexing")
    x = x.contiguous()
    f32 = [t.to(torch.float32).contiguous() for t in (scale, bias)]
    tb = (None if extra_bias is None
          else extra_bias.to(torch.float32).contiguous())
    y = torch.empty_like(x)
    sums = torch.zeros((2, bsz, c), dtype=torch.float32, device=x.device)
    fn = _cuda.entry("group_norm", "natdiff_group_norm", _GN_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_DTYPES[x.dtype], x.data_ptr(), f32[0].data_ptr(),
                 f32[1].data_ptr(), None if tb is None else tb.data_ptr(),
                 0 if tb is None else tb.shape[0], act == "silu",
                 y.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), bsz,
                 hh * ww, c, c // num_groups, eps, _cuda.stream_ptr(x))
    _cuda.check("group_norm", err, "fused_group_norm")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
