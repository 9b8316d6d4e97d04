"""Multi-head attention (port of ``naturaldiffusion_tpu/ops/attention.py``).

* :func:`mha` — ``q/k/v [B, H, T, D] -> [B, H, T, D]``, non-causal.  The
  ``"auto"`` and ``"flash"`` backends run :func:`flash_attention`: kernel
  K9 (``csrc/attention.cu``) for a CUDA tensor, :func:`mha_reference` for a
  CPU one.  ``"xla"`` is the plain einsum pair in the input type, as the
  JAX package's (``ops/attention.py:138-141``).
* :func:`mha_reference` — the plain version of K9: both products and the
  softmax in float32, output in q's type.

The JAX package's ``"auto"`` picks its flash kernel only on a TPU and only
for ``t >= 256``; here every CUDA call takes the kernel, which masks keys
past ``t`` itself and so takes any ``t`` (DiT's 256, SD3's 4096 + 154).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 72)
# natdiff_flash_attention(dtype, d, q, k, v, o, s_b, s_h, s_t, o_b, o_h,
# o_t, B, H, T, scale_log2, stream)
_FA_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_void_p])
_SPLASH = ("the splash kernel (K10) comes with the tooling slice "
           "(ROADMAP.md, Queue A, slice 9)")
_UNPORTED = {"ring": "ring attention comes with the parallelism slice "
                     "(ROADMAP.md, Queue A, slice 8)",
             "splash": _SPLASH, "splash_interpret": _SPLASH}


def mha_reference(q, k, v, sm_scale: float):
    """Plain version: ``softmax(sm_scale * q k^T) v`` in float32."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def mha_xla(q, k, v, sm_scale: float):
    """The JAX package's ``"xla"`` branch: both products and the softmax in
    the input type, so for bf16 the scores and the probabilities are
    rounded to bf16 as there.  For float32 it is :func:`mha_reference`."""
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _kernel_strides(q, k, v):
    """(s_b, s_h, s_t) shared by q, k and v when the kernel can read them
    in place (head dim contiguous, rows 16-byte aligned), else None."""
    st = q.stride()
    if any(t.stride() != st for t in (k, v)) or st[3] != 1:
        return None
    if any(s % 8 for s in st[:3]) or any(t.data_ptr() % 16 for t in (q, k, v)):
        return None
    return st[:3]


def flash_attention(q, k, v, sm_scale: float):
    """Non-causal attention over ``[B, H, T, D]``, softmax in f32, output in
    q's type.  A CPU tensor takes :func:`mha_reference`; a CUDA tensor takes
    kernel K9 (float32 or bfloat16, D in {16, 32, 64, 72}) or raises.

    q, k and v may be strided views (the DiT splits one qkv tensor
    ``[B, T, 3, H, D]``); the kernel reads them in place when their strides
    allow, else from contiguous copies.  The output is a ``[B, H, T, D]``
    view of a ``[B, T, H, D]`` tensor, so transposing it back to tokens is
    free."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v on several devices")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, t, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims "
                         f"{_HEAD_DIMS}, got {d}")
    if t == 0 or b * h > 65535:
        raise ValueError(f"the attention kernel takes 1 <= T and B*H <= "
                         f"65535, got T={t}, B*H={b * h}")
    st = _kernel_strides(q, k, v)
    if st is None:
        q, k, v = (a.contiguous() for a in (q, k, v))
        st = q.stride()[:3]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    fn = _cuda.entry("attention", "natdiff_flash_attention", _FA_ARGTYPES)
    with _cuda.on_device(q):
        err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), st[0], st[1], st[2],
                 out.stride(0), out.stride(2), out.stride(1), b, h, t,
                 sm_scale * math.log2(math.e), _cuda.stream_ptr(q))
    _cuda.check("attention", err, "flash_attention")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0


def mha(q, k, v, *, backend: str = "auto", sm_scale: float | None = None):
    """q/k/v: [B, H, T, D] -> [B, H, T, D]; ``sm_scale`` defaults to
    1/sqrt(D).  ``backend``: ``"auto"`` or ``"flash"`` (kernel K9 on the
    card), ``"xla"`` (the plain einsum pair); ``"ring"`` and ``"splash"``
    are not ported yet."""
    if backend in _UNPORTED:
        raise NotImplementedError(f"backend={backend!r} is not ported yet: "
                                  f"{_UNPORTED[backend]}")
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if backend in ("auto", "flash"):
        return flash_attention(q, k, v, sm_scale)
    if backend == "xla":
        return mha_xla(q, k, v, sm_scale)
    raise ValueError(f"unknown attention backend {backend!r}")


def mha_joint(q, k, v, *, split: int, sm_scale: float | None = None,
              backend: str = "auto", block: int = 512,
              interpret: bool = False):
    """Split-softmax joint attention (``mha_joint`` of the JAX package):
    not ported yet."""
    raise NotImplementedError(
        "mha_joint is not ported yet: it comes with the tooling slice "
        "(ROADMAP.md, Queue A, slice 9)")
