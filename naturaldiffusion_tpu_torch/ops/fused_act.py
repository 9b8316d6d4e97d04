"""Fused bias-add + leaky ReLU (port of
``naturaldiffusion_tpu/ops/fused_act.py``): ``scale * leaky_relu(x +
bias)`` with StyleGAN2's ``negative_slope=0.2`` and ``scale=sqrt(2)``, the
bias broadcast over the channel (last) axis.

* :func:`fused_leaky_relu` -- the plain version, in x's type.
* :func:`fused_leaky_relu_pallas` -- kernel K8 (``csrc/fused_act.cu``,
  replacing ``_flr_kernel``) for a CUDA tensor; the plain version for a CPU
  one or with ``interpret=True``.

As in the JAX package, no model calls either: the reference carries the op
as StyleGAN2 vendor code and never splices it into a forward.

Each operation rounds to x's type, as JAX computes it: the bias is cast to
x's type, and the slope and scale are rounded to x's type before they
multiply (a Python float meets a JAX array as a weakly typed scalar of the
array's dtype).  Kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ._autograd import inference_only

SQRT2 = 1.4142135623730951
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# natdiff_fused_leaky_relu(dtype, x, bias, y, M, C, slope, scale, stream)
_FLR_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p])


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2):
    """``scale * leaky_relu(x + bias)``, in x's type; ``bias`` [C] or None."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.dim() - 1) + (-1,)).to(x.dtype)
    slope = torch.tensor(negative_slope, dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, x, x * slope) * torch.tensor(
        scale, dtype=x.dtype, device=x.device)


@inference_only("fused_leaky_relu_pallas (K8)")
def fused_leaky_relu_pallas(x, bias, negative_slope: float = 0.2,
                            scale: float = SQRT2, interpret: bool = False):
    """The fused op over ``x`` [..., C] with ``bias`` [C]: kernel K8 for a
    CUDA tensor (float32 or bfloat16, else it raises), the plain version for
    a CPU tensor or with ``interpret=True``."""
    c = x.shape[-1]
    if bias.shape != (c,):
        raise ValueError(f"bias must be [{c}], got {tuple(bias.shape)}")
    if bias.device != x.device:
        raise ValueError(f"x on {x.device}, bias on {bias.device}")
    if interpret or x.device.type == "cpu":
        return fused_leaky_relu(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the fused leaky ReLU kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    x = x.contiguous()
    b = bias.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    m = x.numel() // c if c else 0
    if m == 0:
        return out
    # the slope and the scale in x's type, as the plain version multiplies
    slope, sc = (float(torch.tensor(v, dtype=x.dtype))
                 for v in (negative_slope, scale))
    fn = _cuda.entry("fused_act", "natdiff_fused_leaky_relu", _FLR_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_DTYPES[x.dtype], x.data_ptr(), b.data_ptr(),
                 out.data_ptr(), m, c, slope, sc, _cuda.stream_ptr(x))
    _cuda.check("fused_act", err, "fused_leaky_relu_pallas")
    fused_leaky_relu_pallas.launches += 1
    return out


fused_leaky_relu_pallas.launches = 0
