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
tensor cores (see the note in ``csrc/qmatmul.cu``).  The kernel reads the
weight packed in its fragment order (:func:`pack_weight`); ``QDense``
packs once per weight state, and a call without ``w_packed`` packs per
call.  :func:`_qm_plan` chooses the kernel's split-K; a split call is two
device launches (the product, then the fixed-order sum of the partials),
and ``matmul_wdq.launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from ._autograd import inference_only

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# natdiff_qmatmul(out_dtype, x, wp, s_w, bias, y, ws, M, N, K, bm, bn, bk,
# stages, splits, smem, stream)
_QM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])

# --- the kernel's plan ---------------------------------------------------------
# constants of csrc/qmatmul.cu (the entry checks them): k per ring stage,
# ring depth, output columns and rows of x per block
_BK, _STAGES, _BN, _BM = 64, 4, 128, 128
# shared memory a block may use on the H100
SMEM_MAX = 232_448
# the card's SMs: a grid of at most this many blocks runs in one wave, one
# block per SM (a second block on an SM shares its tensor cores)
_SMS = 132
# k tiles of _BK a split keeps at least, and the most splits a call takes
_MIN_SPLIT_TILES, _MAX_SPLITS = 4, 16


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


def _qm_plan(m: int, k: int, n: int) -> dict:
    """The kernel's launch for ``[m, k] @ [k, n]``: blocks of ``_BM`` rows
    by ``_BN`` columns, and the most splits of k that keep the grid within
    one wave of ``_SMS`` blocks, each split keeping at least
    ``_MIN_SPLIT_TILES`` k tiles (one split where the unsplit grid is
    already larger).  On the H100 at DiT-XL/2's products a full wave of
    split blocks beat both fewer blocks and a second wave (PERF.md §6).
    Split ``s`` of ``S`` takes k tiles ``[s KT // S, (s + 1) KT // S)``.
    Pure: the CPU tests walk it, and the C entry checks it against its own
    constants."""
    if m <= 0 or k % _BK or n % _BN or k <= 0:
        raise ValueError(f"matmul_wdq: no plan for M={m} K={k} N={n}")
    kt = k // _BK
    base = (n // _BN) * -(-m // _BM)
    splits = 1
    while (splits < _MAX_SPLITS and kt // (splits + 1) >= _MIN_SPLIT_TILES
           and base * (splits + 1) <= _SMS):
        splits += 1
    return dict(bm=_BM, bn=_BN, bk=_BK, stages=_STAGES, splits=splits,
                grid=(n // _BN, -(-m // _BM), splits),
                k_tiles=[(s * kt // splits, (s + 1) * kt // splits)
                         for s in range(splits)],
                smem=1024 + _STAGES * (_BM * _BK * 2 + _BN * _BK)
                + 2 * _STAGES * 8)


@functools.lru_cache(maxsize=256)
def _plan_ints(m: int, k: int, n: int):
    """:func:`_qm_plan` as the C entry takes it, cached: a launch's host
    time counts on the host-bound DiT path."""
    p = _qm_plan(m, k, n)
    return p["bm"], p["bn"], p["bk"], p["stages"], p["splits"], p["smem"]


def pack_weight(w_i8):
    """The int8 ``[K, N]`` weight in kernel K7's fragment order, a
    ``[K/16, N/32, 512]`` int8 tensor: group ``(kb, nq)`` holds rows
    ``16 kb ..`` and columns ``32 nq ..``, and within it lane ``4 g + t``
    of a warp finds its 16 bytes, for n8 tiles ``j = 0..3`` the bytes
    ``w[k, n]`` with ``n = 32 nq + 8 j + g`` and
    ``k = 16 kb + 2 t + (0, 8, 1, 9)``: byte ``4 j + 2 p + h`` is
    ``k = 16 kb + 8 h + 2 t + p``.  That is the A operand of ``wgmma``
    from registers for the transposed product (``csrc/qmatmul.cu``).  Pure
    torch, on w's device."""
    k, n = w_i8.shape
    if w_i8.dtype != torch.int8 or k % 16 or n % 32:
        raise ValueError(f"pack_weight takes int8 [16 a, 32 b], got "
                         f"{w_i8.dtype} {tuple(w_i8.shape)}")
    # (kb, h, t, p, nq, j, g) -> (kb, nq, g, t, j, p, h)
    return (w_i8.reshape(k // 16, 2, 4, 2, n // 32, 4, 8)
            .permute(0, 4, 6, 2, 5, 3, 1).reshape(k // 16, n // 32, 512))


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


@inference_only("matmul_wdq (K7)")
def matmul_wdq(x, w_i8, s_w, bias=None, w_packed=None):
    """``x [..., K] @ dequant(w_i8 [K, N], s_w [N]) (+ bias [N])`` ->
    ``[..., N]`` in x's type.  Raises where :func:`qmatmul_ok` fails, as the
    JAX package does.  A CPU tensor takes the plain version; a CUDA tensor
    takes kernel K7 (x float32 or bfloat16) or raises.  ``w_packed`` is
    ``pack_weight(w_i8)``, made once by a caller that keeps the weight
    (``QDense``); without it the call packs ``w_i8`` itself."""
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
    if m > 65535 * _BM:                       # the kernel's grid.y
        raise ValueError(f"the W8A16 kernel takes M <= {65535 * _BM}, got "
                         f"{m}")
    if w_packed is None:
        w_packed = pack_weight(w_i8)
    if (w_packed.dtype != torch.int8 or w_packed.device != x.device
            or tuple(w_packed.shape) != (k // 16, n // 32, 512)):
        raise ValueError(f"w_packed must be pack_weight(w_i8), int8 "
                         f"[{k // 16}, {n // 32}, 512] on {x.device}")
    xb = x.reshape(m, k).to(torch.bfloat16).contiguous()
    wp = w_packed.contiguous()
    sw = s_w.reshape(n).to(torch.float32).contiguous()
    b = (None if bias is None
         else bias.reshape(n).to(torch.float32).contiguous())
    if any(t.data_ptr() % 16 for t in (xb, wp, sw, b) if t is not None):
        raise ValueError("the W8A16 kernel needs 16-byte aligned operands")
    y = _launch(xb, wp, sw, b, x.dtype, _plan_ints(m, k, n))
    matmul_wdq.launches += 1
    return y.reshape(*x.shape[:-1], n)


def _launch(xb, wp, sw, b, out_dtype, plan):
    """One call of kernel K7 on checked CUDA operands (bf16 ``xb [M, K]``,
    the packed weight, f32 scale and bias) with ``plan``, the C entry's
    plan integers; a split plan gets its f32 workspace here."""
    m, k = xb.shape
    n = sw.numel()
    splits = plan[4]
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=xb.device)
          if splits > 1 else None)
    y = torch.empty((m, n), dtype=out_dtype, device=xb.device)
    fn = _cuda.entry("qmatmul", "natdiff_qmatmul", _QM_ARGTYPES)
    with _cuda.on_device(xb):
        err = fn(_OUT_DTYPES[out_dtype], xb.data_ptr(), wp.data_ptr(),
                 sw.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), None if ws is None else ws.data_ptr(), m, n,
                 k, *plan, _cuda.stream_ptr(xb))
    _cuda.check("qmatmul", err, "matmul_wdq")
    return y


matmul_wdq.launches = 0
