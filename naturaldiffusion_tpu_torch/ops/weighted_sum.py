"""Fused weighted sum over the buffers of cached tensors — the NI hot op.

At step k the engine computes ``z = sum_j wx[j] * bufx[j] + sum_j we[j] *
bufe[j]``: ``bufx`` holds every past predicted x0, ``bufe`` the initial and
injected noises, and ``wx``/``we`` are row k of the coefficient matrices
(port of ``naturaldiffusion_tpu/ops/weighted_sum.py``).

* :func:`weighted_sum` — the plain ``[1, n] @ [n, M]`` contraction
  (``weighted_sum_xla``).
* :func:`fused_weighted_sum` — both buffers and the final add in one pass
  over the live rows only, by the CUDA kernel ``csrc/weighted_sum.cu`` for a
  CUDA tensor and by :func:`fused_weighted_sum_reference` for a CPU one.
  :func:`_ws_plan` splits the live rows into groups that threads of one
  block sum side by side.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from ._autograd import inference_only

# natdiff_weighted_sum(wx, we, bufx, bufe, live_x, live_e, m, split, out,
# stream)
_WS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p])

# constants of csrc/weighted_sum.cu: threads a block; the card's SMs
_THREADS, _SMS = 256, 132
SPLITS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=256)
def _ws_plan(m: int, live_x: int, live_e: int) -> dict:
    """The kernel's launch for ``M = m`` and ``live_x + live_e`` live rows:
    ``split`` groups of contiguous rows (the x rows, then the eps rows), each
    summed by ``_THREADS // split`` threads of a block over as many float4
    columns.  The split doubles while the grid has fewer blocks than the
    card has SMs and every group keeps at least 4 rows: CIFAR's batch of 64
    (M = 196,608) takes 1, DiT's one latent (M = 4,096) 8.  Group ``g`` of
    ``S`` takes rows ``[g L // S, (g + 1) L // S)``.  Pure: the CPU tests
    walk it."""
    rows = live_x + live_e
    m4 = m // 4
    split = 1
    while (split < SPLITS[-1] and -(-m4 // (_THREADS // split)) < _SMS
           and rows >= 8 * split):
        split *= 2
    cols = _THREADS // split
    return dict(split=split, cols=cols, blocks=-(-m4 // cols),
                groups=[(g * rows // split, (g + 1) * rows // split)
                        for g in range(split)],
                smem=16 * (split - 1) * cols + 4 * rows)


def weighted_sum(w: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``sum_j w[j] * buf[j]`` in float32 (float64 for a float64 ``buf``,
    the CPU-only parity runs).  ``w``: [n]; ``buf``: [n, ...]."""
    acc = torch.promote_types(buf.dtype, torch.float32)
    flat = buf.reshape(buf.shape[0], -1).to(acc)
    return (w.to(acc).reshape(1, -1) @ flat).reshape(buf.shape[1:])


def fused_weighted_sum_reference(wx, we, bufx, bufe, live_x: int,
                                 live_e: int) -> torch.Tensor:
    """Plain version of the kernel: the same sum over the live rows."""
    return (weighted_sum(wx[:live_x], bufx[:live_x])
            + weighted_sum(we[:live_e], bufe[:live_e]))


def _check(wx, we, bufx, bufe, live_x, live_e):
    if bufx.dim() != 2 or bufe.dim() != 2 or bufx.shape[1] != bufe.shape[1]:
        raise ValueError(f"buffers must be [rows, M] with one M, got "
                         f"{tuple(bufx.shape)} and {tuple(bufe.shape)}")
    if not (0 <= live_x <= min(bufx.shape[0], wx.numel())
            and 0 <= live_e <= min(bufe.shape[0], we.numel())):
        raise ValueError(f"live rows ({live_x}, {live_e}) exceed buffers "
                         f"{bufx.shape[0]}/{bufe.shape[0]} or weights "
                         f"{wx.numel()}/{we.numel()}")
    devs = {t.device for t in (wx, we, bufx, bufe)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


@inference_only("fused_weighted_sum (K1)")
def fused_weighted_sum(wx, we, bufx, bufe, live_x: int,
                       live_e: int) -> torch.Tensor:
    """``wx[:live_x] @ bufx[:live_x] + we[:live_e] @ bufe[:live_e]`` -> [M] f32.

    ``wx`` [>= live_x], ``we`` [>= live_e], ``bufx`` [nx, M], ``bufe``
    [ne, M].  Rows at and past ``live_*`` are never read.  A CPU tensor takes
    the plain version; a CUDA tensor takes the kernel (float32, contiguous,
    M a multiple of 4) or raises.
    """
    _check(wx, we, bufx, bufe, live_x, live_e)
    if bufx.device.type == "cpu":
        return fused_weighted_sum_reference(wx, we, bufx, bufe, live_x, live_e)
    if bufx.device.type != "cuda":
        raise ValueError(f"unsupported device {bufx.device}")
    ts = (wx, we, bufx, bufe)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError("the weighted-sum kernel takes contiguous float32 "
                         "tensors")
    m = bufx.shape[1]
    if m == 0 or m % 4 or any(t.data_ptr() % 16 for t in (bufx, bufe)):
        raise ValueError(f"the weighted-sum kernel needs M % 4 == 0 and "
                         f"16-byte aligned buffers (M={m})")
    if live_x + live_e > 12288:               # 48 KB of the weight buffer
        raise ValueError(f"{live_x + live_e} live rows exceed the kernel's "
                         f"weight buffer")
    return _launch(wx, we, bufx, bufe, live_x, live_e,
                   _ws_plan(m, live_x, live_e)["split"])


def _launch(wx, we, bufx, bufe, live_x: int, live_e: int,
            split: int) -> torch.Tensor:
    """One launch of the kernel with ``split`` row groups (checked
    arguments; the checks also time the splits the plan does not pick)."""
    m = bufx.shape[1]
    out = torch.empty(m, dtype=torch.float32, device=bufx.device)
    fn = _cuda.entry("weighted_sum", "natdiff_weighted_sum",
                     _WS_ARGTYPES)
    with _cuda.on_device(bufx):
        err = fn(wx.data_ptr(), we.data_ptr(), bufx.data_ptr(),
                 bufe.data_ptr(), live_x, live_e, m, split, out.data_ptr(),
                 _cuda.stream_ptr(bufx))
    _cuda.check("weighted_sum", err, "weighted_sum")
    fused_weighted_sum.launches += 1
    return out


fused_weighted_sum.launches = 0
