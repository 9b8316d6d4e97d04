"""Weight-only int8 matrix product, W8A16 (port of ``naturaldiffusion_tpu/
ops/qmatmul.py``).

``matmul_wdq(x, w_i8, s_w, bias)`` computes ``bf16(x) @ bf16(w_i8)`` with
f32 accumulation, times the per-column f32 scale, plus the bias, in x's
type: kernel K7 (``csrc/qmatmul.cu``) for a CUDA tensor,
:func:`matmul_wdq_reference` for a CPU one.  The int8 values are exact in
bf16, so the only approximation is the quantization itself
(:func:`.quant.quantize_weight`).

On the H100 this kernel is bounded by operations at DiT-XL/2's 512 rows,
not by the weight bytes that justify it on a TPU v5e; it runs on the
tensor cores (see the note in ``csrc/qmatmul.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# natdiff_qmatmul(out_dtype, x, w, s_w, bias, y, M, N, K, stream)
_QM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])


def _pick_block(total: int, candidates) -> int | None:
    for c in candidates:
        if total % c == 0:
            return c
    return None


def qmatmul_ok(m: int, k: int, n: int) -> bool:
    """Shape gate of the JAX package, copied as it is: it decides which
    ``QDense`` layers take the kernel."""
    return (k % 128 == 0 and _pick_block(n, (512, 256, 128)) is not None
            and _pick_block(m, (256, 128, 64, 32, 16)) is not None
            and k <= 8192)


def matmul_wdq_reference(x, w_i8, s_w, bias=None):
    """Plain version: x rounded to bf16 (also an f32 x, as the TPU kernel
    does), the product in f32, then ``* s_w (+ bias)`` in f32, cast to x's
    type."""
    k, n = w_i8.shape
    xb = x.reshape(-1, k).to(torch.bfloat16).to(torch.float32)
    acc = xb @ w_i8.to(torch.float32)
    acc = acc * s_w.reshape(1, n).to(torch.float32)
    if bias is not None:
        acc = acc + bias.reshape(1, n).to(torch.float32)
    return acc.to(x.dtype).reshape(*x.shape[:-1], n)


def matmul_wdq(x, w_i8, s_w, bias=None):
    """``x [..., K] @ dequant(w_i8 [K, N], s_w [N]) (+ bias [N])`` ->
    ``[..., N]`` in x's type.  Raises where :func:`qmatmul_ok` fails, as the
    JAX package does.  A CPU tensor takes the plain version; a CUDA tensor
    takes kernel K7 (x float32 or bfloat16) or raises."""
    k = x.shape[-1]
    if w_i8.dim() != 2 or w_i8.shape[0] != k or w_i8.dtype != torch.int8:
        raise ValueError(f"w_i8 must be int8 [{k}, N], got {w_i8.dtype} "
                         f"{tuple(w_i8.shape)}")
    n = w_i8.shape[1]
    m = x.numel() // k if k else 0
    if not qmatmul_ok(m, k, n):
        raise ValueError(f"matmul_wdq shape gate failed for M={m} K={k} "
                         f"N={n} (caller must pre-check qmatmul_ok)")
    if s_w.numel() != n or (bias is not None and bias.numel() != n):
        raise ValueError(f"s_w and bias must have {n} elements")
    ts = [t for t in (x, w_i8, s_w, bias) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("tensors on several devices")
    if x.device.type == "cpu":
        return matmul_wdq_reference(x, w_i8, s_w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _OUT_DTYPES:
        raise ValueError(f"the W8A16 kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if m > 65535 * 128:                       # the kernel's grid.y
        raise ValueError(f"the W8A16 kernel takes M <= {65535 * 128}, got "
                         f"{m}")
    xb = x.reshape(m, k).to(torch.bfloat16).contiguous()
    w = w_i8.contiguous()
    sw = s_w.reshape(n).to(torch.float32).contiguous()
    b = (None if bias is None
         else bias.reshape(n).to(torch.float32).contiguous())
    if any(t.data_ptr() % 16 for t in (xb, w)):
        raise ValueError("the W8A16 kernel needs 16-byte aligned x and w")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _cuda.entry("qmatmul", "natdiff_qmatmul", _QM_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_OUT_DTYPES[x.dtype], xb.data_ptr(), w.data_ptr(),
                 sw.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), m, n, k, _cuda.stream_ptr(x))
    _cuda.check("qmatmul", err, "matmul_wdq")
    matmul_wdq.launches += 1
    return y.reshape(*x.shape[:-1], n)


matmul_wdq.launches = 0
