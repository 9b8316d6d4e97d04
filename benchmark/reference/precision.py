"""The precision a reference computes in.

``F32``: every product in float32 (the caller turns TF32 off:
:func:`no_tf32`).  ``FP8``: the control, the step below the configurations'
bfloat16: both operands of every product (matrix products, convolutions,
the attention's two products) are rounded to float8 e4m3 with one scale a
tensor (its largest magnitude onto e4m3's 448), and the product is then
taken in float32.  Norms, softmax, activations and the sampler's sums stay
in float32 on both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    """Products in float32 on operands rounded by :meth:`round`."""

    name = "f32"

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def linear(self, x, w, b=None):
        """``x @ w (+ b)``, ``w`` as ``[in, out]``."""
        y = self.round(x) @ self.round(w)
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        """NHWC ``x``, ``w`` as ``[kh, kw, in, out]``."""
        y = F.conv2d(self.round(x).permute(0, 3, 1, 2),
                     self.round(w).permute(3, 2, 0, 1), b, stride=stride,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class FP8(Precision):
    name = "fp8_e4m3"

    def round(self, t):
        amax = t.detach().abs().amax().float().clamp_min(1e-12)
        s = amax / E4M3_MAX
        return (t.float() / s).to(torch.float8_e4m3fn).float() * s


F32 = Precision()
CONTROL = FP8()


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN convolutions within the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
