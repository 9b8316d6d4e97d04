"""upfirdn2d -- upsample, FIR-filter, downsample, NHWC (port of
``naturaldiffusion_tpu/ops/upfirdn2d.py:29-126``).

    zero-stuff by ``up`` -> zero-pad -> convolve with the 2-D FIR kernel
    (a true convolution: the kernel is flipped) -> stride by ``down``.

Plain PyTorch, as the JAX package's is plain XLA: the zero-stuffing is
written out, the filter is one depthwise ``F.conv2d``.  No kernel of the
TPU package lies on this path.  Outputs are contiguous NHWC, as the conv
kernels that read them require.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _stuff(x, factor: int, trailing: bool):
    """NCHW ``x`` with ``factor - 1`` zeros after every row and column
    (``trailing``: also after the last, as the reference's zero-stuffing;
    else only between samples, as ``lhs_dilation``)."""
    if factor == 1:
        return x
    n, c, h, w = x.shape
    z = x.new_zeros((n, c, h, factor, w, factor))
    z[:, :, :, 0, :, 0] = x
    z = z.reshape(n, c, h * factor, w * factor)
    if not trailing:
        z = z[:, :, :(h - 1) * factor + 1, :(w - 1) * factor + 1]
    return z


def upfirdn2d(x, kernel, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)):
    """``x`` [N, H, W, C]; ``kernel`` [kh, kw] FIR filter.  Returns
    [N, H', W', C] with ``H' = (H*up + pad0 + pad1 - kh) // down + 1``
    (``upfirdn2d.py:29``)."""
    c = x.shape[3]
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    kh, kw = k.shape
    k = k.flip(0, 1).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    y = _stuff(x.permute(0, 3, 1, 2), up, trailing=True)
    y = F.pad(y, (pad[0], pad[1], pad[0], pad[1]))
    y = F.conv2d(y, k, stride=down, groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def _setup_kernel(k) -> np.ndarray:
    """A 1-D (outer-product) or 2-D FIR kernel, normalised to sum 1,
    float64 (``upfirdn2d.py:69``)."""
    k = np.asarray(k, dtype=np.float64)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    return k


def upsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    """FIR upsample by ``factor`` (``upfirdn2d.py:83``)."""
    k = _setup_kernel([1] * factor if k is None else k) * (gain * factor ** 2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x, k=None, factor: int = 2, gain: float = 1.0):
    """FIR downsample by ``factor`` (``upfirdn2d.py:93``)."""
    k = _setup_kernel([1] * factor if k is None else k) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def _conv_nhwc(x, w, stride: int = 1, padding: int = 0):
    """``x`` NCHW, ``w`` [kh, kw, Cin, Cout] -> NCHW cross-correlation."""
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                    padding=padding)


def upsample_conv_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Fused upsample + conv (``upfirdn2d.py:103``): zero-stuff between
    samples, full-pad by ``kh - 1``, correlate with ``w`` [kh, kw, Cin,
    Cout], then the FIR pass.  Output [N, H*factor, W*factor, Cout]."""
    ch, cw = w.shape[:2]
    if ch != cw:
        raise ValueError(f"conv kernel must be square, got {tuple(w.shape)}")
    k = _setup_kernel([1] * factor if k is None else k) * (gain * factor ** 2)
    p = (k.shape[0] - factor) - (cw - 1)
    y = _stuff(x.permute(0, 3, 1, 2), factor, trailing=False)
    y = _conv_nhwc(y, w, padding=ch - 1).permute(0, 2, 3, 1)
    return upfirdn2d(y, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Fused conv + downsample (``upfirdn2d.py:116``): the FIR pass, then
    a VALID conv with stride ``factor``."""
    ch, cw = w.shape[:2]
    if ch != cw:
        raise ValueError(f"conv kernel must be square, got {tuple(w.shape)}")
    k = _setup_kernel([1] * factor if k is None else k) * gain
    p = (k.shape[0] - factor) + (cw - 1)
    y = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    return _conv_nhwc(y.permute(0, 3, 1, 2), w,
                      stride=factor).permute(0, 2, 3, 1).contiguous()
