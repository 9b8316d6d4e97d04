"""Multi-head attention (port of ``naturaldiffusion_tpu/ops/attention.py``).

* :func:`mha` — ``q/k/v [B, H, T, D] -> [B, H, T, D]``, non-causal.  The
  ``"auto"`` and ``"flash"`` backends run :func:`flash_attention`: kernel
  K9 (``csrc/attention.cu``) for a CUDA tensor, :func:`mha_reference` for a
  CPU one.  ``"splash"`` runs :func:`splash_attention`, kernel K10 (the same
  source's splash entry) on pre-scaled q; ``"splash_interpret"`` its plain
  version :func:`splash_reference`.  ``"xla"`` is the plain einsum pair in
  the input type, as the JAX package's (``ops/attention.py:138-141``).
* :func:`mha_reference` — the plain version of K9: both products and the
  softmax in float32, output in q's type.
* :func:`mha_joint` — split-softmax joint attention over ``[latent;
  context]``, its latent block through K10 with the row logsumexp.  It has
  no gradient, as in JAX (splash's ``save_residuals`` forward has no VJP).
* Gradients: under grad mode K9 and K10 are one ``torch.autograd.Function``
  (:class:`_AttentionFn`): the forward keeps the row logsumexp, the
  backward is the kernel of ``csrc/attention_bwd.cu`` for a CUDA tensor
  (:func:`flash_attention_backward`, :func:`splash_attention_backward`)
  and :func:`attention_backward_reference` for a CPU one.
* ``mha(backend="ring", mesh=...)`` is ring attention over a mesh axis
  (:mod:`.ring_attention`).

The wrappers take local tensors: a DTensor raises (the models convert at
their boundary, ``to_local`` / ``from_local``).

The JAX package's ``"auto"`` picks its flash kernel only on a TPU and only
for ``t >= 256``; here every CUDA call takes the kernel, which masks keys
past ``t`` itself and so takes any ``t`` (DiT's 256, SD3's 4096 + 154).  The
same index mask replaces the segment ids by which JAX's splash path masks
its pad keys.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda
from ._autograd import NoBackward, needs_grad, refuse_dtensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 72)
# natdiff_flash_attention(dtype, d, q, k, v, o, lse, s_b, s_h, s_t, o_b,
# o_h, o_t, B, H, T, scale_log2, warps, stages, smem, stream)
_FA_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# natdiff_splash_attention(dtype, d, q, k, v, o, lse, s_b, s_h, s_t, o_b,
# o_h, o_t, B, H, T, warps, stages, smem, stream)
_SPLASH_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                    + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])
# natdiff_attention_bwd(dtype, d, q, k, v, o, do, lse, work, dq, dk, dv,
# s_b, s_h, s_t, o_b, o_h, o_t, d_b, d_h, d_t, g_b, g_h, g_t, B, H, T,
# scale, path, bkv, bq, stages, smem, stream)
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# --- the kernel's block plan ---------------------------------------------------
# constants of csrc/attention.cu (the entry checks them): keys per tile,
# stages of the bf16 kernel's K/V ring, queries per warp
_BKV, _RING_STAGES, _WARP_ROWS = 64, 3, 16
# blocks a bf16 launch of 8 warps should reach, else it takes 4 warps: two
# per SM of the card's 132
_MIN_BLOCKS_8 = 264


def _attn_plan(b: int, h: int, t: int, d: int, dtype) -> dict:
    """The tile loop's launch for ``[b, h, t, d]``.  bfloat16: blocks of 8
    warps (128 queries) where d <= 64 and that grid still reaches
    ``_MIN_BLOCKS_8`` blocks, else of 4 warps (64 queries); the K/V ring's
    shared memory.  float32: the split kernel's fixed blocks of 4 warps, no
    ring (stages and smem 0).  Block ``(x, y)`` writes queries ``[x bq, (x + 1) bq)``
    below t of head ``y``; key tile ``j`` holds keys ``[64 j, 64 j + 64)``,
    masked past t only in the last, ragged one.  Pure: the CPU tests walk
    it, and the C entry checks it against its own constants."""
    if t <= 0 or b <= 0 or h <= 0 or d not in _HEAD_DIMS:
        raise ValueError(f"attention: no plan for {(b, h, t, d)}")
    tiles = -(-t // _BKV)
    if dtype == torch.float32:
        warps, stages, smem = 4, 0, 0
    else:
        warps = (8 if d <= 64 and -(-t // (8 * _WARP_ROWS)) * b * h
                 >= _MIN_BLOCKS_8 else 4)
        sk = -(-d // 16) * 16 + 8           # row stride of Q, K, V tiles
        stages = _RING_STAGES
        smem = (_WARP_ROWS * warps + 2 * stages * _BKV) * sk * 2
    bq = _WARP_ROWS * warps
    return dict(warps=warps, bq=bq, stages=stages, smem=smem,
                grid=(-(-t // bq), b * h), key_tiles=tiles,
                masked_tiles=[tiles - 1] if t % _BKV else [])


# constants of csrc/attention_bwd.cu (its entry checks the plan): rows of
# the f32 kernels' tiles; of the bf16 mma.sync kernels' (d 16, 32); the
# wgmma pass (d 64, 72): keys a block (two consumer warpgroups of 64),
# queries a ring stage, ring stages, columns of a TMA box (one 128-byte
# swizzled row)
_BWD_FT, _BWD_BT = 32, 64
_BWD_BKV, _BWD_BQ, _BWD_STAGES, _BWD_BOX = 128, 64, 2, 64
_BWD_PATHS = ("fma", "mma", "wgmma")


def _bwd_plan(b: int, h: int, t: int, d: int, dtype) -> dict:
    """The backward's launch plan for ``[b, h, t, d]`` (pure: the CPU tests
    walk it, and the C entry checks it against its constants).

    * float32: ``"fma"``, the checking path: the delta pre-pass, the dk/dv
      and the dq kernels on 32-row tiles; ``work`` is delta, ``[b h][t]``.
    * bfloat16, d 16 or 32: ``"mma"``, the same three launches on 64-row
      mma.sync tiles.
    * bfloat16, d 64 or 72: ``"wgmma"``, one pass over key blocks of 128
      (``grid``), each walking every query tile of 64 through a ring of
      ``stages``: 5 products a tile pair on ``wgmma``, dq summed in f32
      ``work`` by bulk reductions; a pre-pass (delta, lse log2 e, the sums
      zeroed) and a post-pass (dq in bf16).  D rounds up to 16 for the
      products over it (``dk``: 80 for 72) and takes ``boxes`` TMA boxes
      of 64 columns; ``tp`` is t rounded up to the query tile; ``work`` is
      ``[b h][tp]`` twice and ``[b h][tp][d]``; ``smem`` the main kernel's
      dynamic shared memory.
    """
    if t <= 0 or b <= 0 or h <= 0 or d not in _HEAD_DIMS \
            or b * h > 65535 or dtype not in _DTYPES:
        raise ValueError(f"attention backward: no plan for "
                         f"{(b, h, t, d)} {dtype}")
    if dtype == torch.float32 or d <= 32:
        rows = _BWD_FT if dtype == torch.float32 else _BWD_BT
        return dict(path=_BWD_PATHS[0 if dtype == torch.float32 else 1],
                    bkv=rows, bq=rows, stages=0, smem=0, tp=t,
                    grid=(-(-t // rows), b * h), work=b * h * t, launches=3)
    boxes = -(-d // _BWD_BOX)
    tp = -(-t // _BWD_BQ) * _BWD_BQ
    kv_tile = boxes * _BWD_BKV * 128          # bytes of K (or V) in shared
    q_tile = boxes * _BWD_BQ * 128            # ... of a Q (or dO) stage
    ds, dq = 64 * 128, _BWD_BQ * d * 4        # a warpgroup's dS^T, dQ part
    smem = (1024 + 2 * kv_tile + 2 * _BWD_STAGES * q_tile + 2 * ds + 2 * dq
            + 2 * _BWD_STAGES * _BWD_BQ * 4 + (2 * _BWD_STAGES + 1) * 8)
    return dict(path=_BWD_PATHS[2], bkv=_BWD_BKV, bq=_BWD_BQ,
                stages=_BWD_STAGES, smem=smem, tp=tp, boxes=boxes,
                dk=-(-d // 16) * 16, grid=(-(-t // _BWD_BKV), b * h),
                work=b * h * tp * (d + 2), launches=3)


@functools.lru_cache(maxsize=256)
def _bwd_plan_ints(b: int, h: int, t: int, d: int, dtype) -> tuple:
    """:func:`_bwd_plan` as the C entry takes it, cached."""
    p = _bwd_plan(b, h, t, d, dtype)
    return (p["work"], _BWD_PATHS.index(p["path"]), p["bkv"], p["bq"],
            p["stages"], p["smem"])


@functools.lru_cache(maxsize=256)
def _plan_ints(b: int, h: int, t: int, d: int, dtype) -> tuple:
    """:func:`_attn_plan` as the C entries take it, cached: a launch's
    host time counts on the host-bound DiT path."""
    p = _attn_plan(b, h, t, d, dtype)
    return p["warps"], p["stages"], p["smem"]


def _ct(q):
    """The plain versions' compute type: float32, float64 for float64."""
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q, k, scale: float):
    ct = _ct(q)
    return torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale


def mha_reference(q, k, v, sm_scale: float):
    """Plain version: ``softmax(sm_scale * q k^T) v`` in float32 (float64
    for float64 inputs)."""
    p = torch.softmax(_scores(q, k, sm_scale), dim=-1)
    return torch.matmul(p, v.to(p.dtype)).to(q.dtype)


def attention_backward_reference(q, k, v, o, do, lse, scale: float):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` of
    ``o = softmax(scale * q k^T) v`` given o, the row logsumexp ``lse`` of
    the scaled scores and the cotangent ``do``, each in its input's type.
    Written out in float32 (float64 for float64 inputs) as the kernel
    computes it: ``p = exp(scale q k^T - lse)``, ``dv = p^T do``,
    ``dS = p * (do v^T - delta)`` with ``delta = rowsum(do * o)``,
    ``dq = scale dS k``, ``dk = scale dS^T q``."""
    ct = _ct(q)
    qf, kf, vf, of, dof = (a.to(ct) for a in (q, k, v, o, do))
    p = torch.exp(_scores(q, k, scale) - lse.to(ct)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_xla(q, k, v, sm_scale: float):
    """The JAX package's ``"xla"`` branch: both products and the softmax in
    the input type, so for bf16 the scores and the probabilities are
    rounded to bf16 as there.  For float32 it is :func:`mha_reference`."""
    s = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _rows_ok(x) -> bool:
    """The head dim is contiguous and every row start 16-byte aligned."""
    return (x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _tma_ok(x) -> bool:
    """:func:`_rows_ok` with every stride positive and below 2^39 elements,
    as a TMA tensor map of the backward's wgmma pass takes them."""
    return _rows_ok(x) and all(0 < s < 2 ** 39 for s in x.stride()[:3])


def _kernel_strides(q, k, v):
    """(s_b, s_h, s_t) shared by q, k and v when the kernel can read them
    in place (:func:`_rows_ok`), else None."""
    st = q.stride()
    if any(t.stride() != st for t in (k, v)) or not all(
            _rows_ok(t) for t in (q, k, v)):
        return None
    return st[:3]


def _check_qkv(q, k, v):
    refuse_dtensor("attention", q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v on several devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch(q, k, v, sm_scale, lse: bool, what: str):
    """One launch of the tile loop of ``csrc/attention.cu`` on CUDA tensors:
    K9's entry with ``sm_scale``, or K10's (``sm_scale=None``: q is
    pre-scaled) with the f32 ``[B, H, T]`` logsumexp when ``lse``.  Returns
    ``(out, lse or None)``; raises on what the kernel does not take."""
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
    res = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if lse else None)
    args = (_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if res is None else res.data_ptr())
    strides = (st[0], st[1], st[2], out.stride(0), out.stride(2),
               out.stride(1), b, h, t)
    plan = _plan_ints(b, h, t, d, q.dtype)
    with _cuda.on_device(q):
        if sm_scale is None:
            fn = _cuda.entry("attention", "natdiff_splash_attention",
                             _SPLASH_ARGTYPES)
            err = fn(*args, *strides, *plan, _cuda.stream_ptr(q))
        else:
            fn = _cuda.entry("attention", "natdiff_flash_attention",
                             _FA_ARGTYPES)
            err = fn(*args, *strides, sm_scale * math.log2(math.e), *plan,
                     _cuda.stream_ptr(q))
    _cuda.check("attention", err, what)
    return out.transpose(1, 2), res


def _launch_bwd(q, k, v, o, do, lse, scale: float, what: str):
    """One call of ``csrc/attention_bwd.cu`` on CUDA tensors, three device
    launches by :func:`_bwd_plan`: in bf16 at d 64 and 72 the pre-pass, the
    wgmma pass and the dq post-pass; otherwise the delta pre-pass, the
    dk/dv and the dq kernels.  Returns ``(dq, dk, dv)``, ``[B, H, T, D]``
    views of ``[B, T, H, D]`` tensors."""
    b, h, t, d = q.shape
    if q.dtype not in _DTYPES or any(a.dtype != q.dtype
                                     for a in (k, v, o, do)):
        raise ValueError(f"the attention backward takes float32 or bfloat16 "
                         f"q, k, v, o, do of one type, got "
                         f"{[a.dtype for a in (q, k, v, o, do)]}")
    if d not in _HEAD_DIMS or b * h > 65535 or t == 0:
        raise ValueError(f"the attention backward takes head dims "
                         f"{_HEAD_DIMS}, T >= 1 and B*H <= 65535, got "
                         f"{(b, h, t, d)}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, t):
        raise ValueError(f"o, do must be {tuple(q.shape)} and lse "
                         f"{(b, h, t)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    st = _kernel_strides(q, k, v)
    if st is None or not all(map(_tma_ok, (q, k, v))):
        q, k, v = (a.contiguous() for a in (q, k, v))
        st = q.stride()[:3]
    o = o if _rows_ok(o) else o.contiguous()
    do = do if _tma_ok(do) else do.contiguous()
    lse = lse.to(torch.float32).contiguous()
    nwork, *plan = _bwd_plan_ints(b, h, t, d, q.dtype)
    work = torch.empty(nwork, dtype=torch.float32, device=q.device)
    grads = torch.empty((3, b, t, h, d), dtype=q.dtype, device=q.device)
    g = grads[0]
    fn = _cuda.entry("attention_bwd", "natdiff_attention_bwd", _BWD_ARGTYPES)
    with _cuda.on_device(q):
        err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 work.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
                 grads[2].data_ptr(), *st, o.stride(0), o.stride(1),
                 o.stride(2), do.stride(0), do.stride(1), do.stride(2),
                 g.stride(0), g.stride(2), g.stride(1), b, h, t, float(scale),
                 *plan, _cuda.stream_ptr(q))
    _cuda.check("attention_bwd", err, what)
    return tuple(grads[i].transpose(1, 2) for i in range(3))


def _attention_backward(q, k, v, o, do, lse, scale, what):
    _check_qkv(q, k, v)
    refuse_dtensor(what, o, do, lse)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, o, do, lse, scale)
    return _launch_bwd(q, k, v, o, do, lse, scale, what)


def flash_attention_backward(q, k, v, o, do, lse, scale: float):
    """K9's backward: ``(dq, dk, dv)`` of ``softmax(scale q k^T) v``, given
    the forward's output ``o`` and row logsumexp ``lse``.  A CUDA tensor
    takes the kernel of ``csrc/attention_bwd.cu`` (float32 or bfloat16, D
    in {16, 32, 64, 72}) or raises; a CPU tensor takes
    :func:`attention_backward_reference`.  ``.launches`` counts calls of
    the kernel (each is three device launches: the delta pre-pass, dk/dv,
    dq)."""
    out = _attention_backward(q, k, v, o, do, lse, scale,
                              "flash_attention_backward")
    if q.device.type == "cuda":
        flash_attention_backward.launches += 1
    return out


flash_attention_backward.launches = 0


def splash_attention_backward(qs, k, v, o, do, lse):
    """K10's backward on pre-scaled ``qs``: the same kernel at scale 1, so
    the returned first gradient is the one of ``qs`` (the scale reaches q's
    through the pre-scaling product).  Counted in ``.launches``."""
    out = _attention_backward(qs, k, v, o, do, lse, 1.0,
                              "splash_attention_backward")
    if qs.device.type == "cuda":
        splash_attention_backward.launches += 1
    return out


splash_attention_backward.launches = 0


def _forward_with_lse(q, k, v, scale, splash: bool):
    """``(out, lse)``: the kernel (counted) for a CUDA tensor, the plain
    version for a CPU one."""
    if q.device.type == "cpu":
        s = _scores(q, k, scale)
        out = torch.matmul(torch.softmax(s, dim=-1), v.to(s.dtype))
        return out.to(q.dtype), torch.logsumexp(s, dim=-1)
    if splash:
        out, lse = _launch(q, k, v, None, True, "splash_attention")
        splash_attention.launches += 1
    else:
        out, lse = _launch(q, k, v, scale, True, "flash_attention")
        flash_attention.launches += 1
    return out, lse


class _AttentionFn(torch.autograd.Function):
    """K9 (``splash=False``) or K10 (``splash=True``, q pre-scaled, scale
    1) under grad: the forward keeps the row logsumexp, the backward runs
    the backward kernel.  A second derivative raises, naming the kernel,
    as JAX's attention kernels have none."""

    @staticmethod
    def forward(ctx, q, k, v, scale, splash):
        out, lse = _forward_with_lse(q, k, v, scale, splash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.splash = scale, splash
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.splash:
            def fn(q_, k_, v_, do_):
                return splash_attention_backward(q_, k_, v_, o, do_, lse)
            label = "splash_attention (K10)"
        else:
            def fn(q_, k_, v_, do_):
                return flash_attention_backward(q_, k_, v_, o, do_, lse,
                                                ctx.scale)
            label = "flash_attention (K9)"
        if needs_grad(q, k, v, do):     # create_graph: keep it, and refuse
            grads = NoBackward.apply(    # its own backward
                f"{label} has no second derivative", fn, q, k, v, do)
        else:
            grads = fn(q, k, v, do)
        return (*grads, None, None)


def flash_attention(q, k, v, sm_scale: float):
    """Non-causal attention over ``[B, H, T, D]``, softmax in f32, output in
    q's type.  A CPU tensor takes :func:`mha_reference`; a CUDA tensor takes
    kernel K9 (float32 or bfloat16, D in {16, 32, 64, 72}) or raises.

    q, k and v may be strided views (the DiT splits one qkv tensor
    ``[B, T, 3, H, D]``); the kernel reads them in place when their strides
    allow, else from contiguous copies.  The output is a ``[B, H, T, D]``
    view of a ``[B, T, H, D]`` tensor, so transposing it back to tokens is
    free.  Under grad it is :class:`_AttentionFn`, whose backward is
    :func:`flash_attention_backward`."""
    _check_qkv(q, k, v)
    if needs_grad(q, k, v):
        return _AttentionFn.apply(q, k, v, sm_scale, False)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, sm_scale)
    out, _ = _launch(q, k, v, sm_scale, False, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def prescale(q, sm_scale: float):
    """``(q * sm_scale).astype(q.dtype)`` as JAX computes it before the
    splash kernel: the Python scale meets q as a weakly typed scalar, so it
    is rounded to q's type before the product, which rounds too."""
    return q * torch.tensor(sm_scale, dtype=q.dtype, device=q.device)


def splash_reference(qs, k, v, *, save_residuals: bool = False):
    """Plain version of K10 on pre-scaled ``qs``: ``softmax(qs k^T) v`` in
    float32, output in qs's type; with ``save_residuals`` also each row's
    natural-log logsumexp of ``qs k^T`` (float32 ``[B, H, T]``)."""
    s = _scores(qs, k, 1.0)
    out = torch.matmul(torch.softmax(s, dim=-1), v.to(s.dtype)).to(qs.dtype)
    if not save_residuals:
        return out
    return out, torch.logsumexp(s, dim=-1)


def _splash(qs, k, v, save_residuals: bool):
    """K10 on pre-scaled ``qs``: the kernel for CUDA tensors, the plain
    version for CPU ones; under grad :class:`_AttentionFn`.  The logsumexp
    output (``save_residuals``) has no gradient: under grad it raises, as
    JAX's ``save_residuals`` splash kernel has no VJP."""
    _check_qkv(qs, k, v)
    if needs_grad(qs, k, v):
        if save_residuals:
            raise NotImplementedError(
                "splash_attention (K10) with save_residuals has no "
                "gradient (JAX's splash kernel has no VJP for its "
                "residuals): call it under torch.no_grad()")
        return _AttentionFn.apply(qs, k, v, 1.0, True)
    if qs.device.type == "cpu":
        return splash_reference(qs, k, v, save_residuals=save_residuals)
    out, lse = _launch(qs, k, v, None, save_residuals, "splash_attention")
    splash_attention.launches += 1
    return (out, lse) if save_residuals else out


def splash_attention(q, k, v, sm_scale: float, *,
                     save_residuals: bool = False):
    """The splash form of attention (JAX ``_splash``): q is pre-scaled in
    torch (:func:`prescale`), then kernel K10 runs on a CUDA tensor
    (float32 or bfloat16, D in {16, 32, 64, 72}, else it raises) and
    :func:`splash_reference` on a CPU one.  With ``save_residuals`` it
    returns ``(out, lse)``, lse the float32 ``[B, H, T]`` natural-log
    logsumexp of the pre-scaled scores."""
    return _splash(prescale(q, sm_scale), k, v, save_residuals)


splash_attention.launches = 0


def mha(q, k, v, *, backend: str = "auto", sm_scale: float | None = None,
        mesh=None, ring_axis: str = "model"):
    """q/k/v: [B, H, T, D] -> [B, H, T, D]; ``sm_scale`` defaults to
    1/sqrt(D).  ``backend``: ``"auto"`` or ``"flash"`` (kernel K9 on the
    card), ``"splash"`` (kernel K10 on the card), ``"splash_interpret"``
    (K10's plain version on any device, as JAX's interpret mode runs the
    kernel's function without the hardware), ``"xla"`` (the plain einsum
    pair), ``"ring"`` (:func:`.ring_attention.ring_mha` over ``mesh``'s
    ``ring_axis``: K/V stay token-sharded and rotate around the ring; a
    DTensor in gives the T-sharded DTensor out, a plain tensor the plain
    gathered output)."""
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if backend == "ring":
        if mesh is None:
            raise ValueError("backend='ring' needs a mesh")
        from .ring_attention import ring_mha
        return ring_mha(q, k, v, mesh, axis=ring_axis, sm_scale=sm_scale)
    if backend in ("auto", "flash"):
        return flash_attention(q, k, v, sm_scale)
    if backend == "splash":
        return splash_attention(q, k, v, sm_scale)
    if backend == "splash_interpret":
        return splash_reference(prescale(q, sm_scale), k, v)
    if backend == "xla":
        return mha_xla(q, k, v, sm_scale)
    raise ValueError(f"unknown attention backend {backend!r}")


def mha_joint(q, k, v, *, split: int, sm_scale: float | None = None,
              backend: str = "auto", block: int = 512,
              interpret: bool = False):
    """Joint ``[latent; context]`` attention by a split softmax (JAX
    ``mha_joint``, ``ops/attention.py:146-234``), equal to one softmax over
    each whole row:

    * latent q x latent kv -- K10 with its logsumexp, on views of the
      pre-scaled q and of k and v (the kernel reads them in place);
    * latent q x context kv -- float32 products, merged with the kernel
      block by the two-way logsumexp combine;
    * context q x all kv -- one float32 row softmax.

    The split path runs for a CUDA tensor, or a CPU one with ``interpret``
    (its latent block then takes :func:`splash_reference`), when
    ``backend != "xla"``, there is context (``split < T``) and ``split`` is
    a positive multiple of ``block``; otherwise this is :func:`mha`, as in
    JAX.  On the TPU the padded :func:`mha` won in-model (JAX
    ``ops/attention.py:164-172``)."""
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    t = q.shape[2]
    t_ctx = t - split
    fast = ((q.is_cuda or interpret) and backend != "xla" and t_ctx > 0
            and split >= block and split % block == 0)
    if not fast:
        return mha(q, k, v, backend=backend, sm_scale=sm_scale)
    _check_qkv(q, k, v)
    if needs_grad(q, k, v):
        raise NotImplementedError(
            "mha_joint has no gradient: its latent block is splash "
            "attention (K10) with save_residuals, whose logsumexp has no "
            "VJP in JAX either (jax.grad through mha_joint raises "
            "'Higher-order AD not supported'); differentiate mha instead")

    f32 = torch.float32
    qs = prescale(q, sm_scale)
    q_lat, q_ctx = qs[:, :, :split], qs[:, :, split:]
    k_ctx, v_ctx = k[:, :, split:], v[:, :, split:]
    out_ll, lse_ll = _splash(q_lat, k[:, :, :split], v[:, :, :split], True)

    # latent q x context kv: f32 products of the input-type operands
    s_lc = torch.matmul(q_lat.to(f32), k_ctx.to(f32).transpose(-1, -2))
    m_lc = s_lc.amax(dim=-1)
    e_lc = torch.exp(s_lc - m_lc[..., None])
    l_lc = e_lc.sum(dim=-1)
    lse_lc = m_lc + torch.log(l_lc)
    out_lc = torch.matmul(e_lc.to(v.dtype), v_ctx)

    # two-way logsumexp merge (out_ll is normalised, out_lc raw exp sums)
    lse = torch.logaddexp(lse_ll, lse_lc)
    w_ll = torch.exp(lse_ll - lse)
    w_lc = torch.exp(lse_lc - lse) / l_lc
    out_lat = (out_ll.to(f32) * w_ll[..., None]
               + out_lc.to(f32) * w_lc[..., None])

    # context queries: one full-row softmax over all t keys
    s_c = torch.matmul(q_ctx.to(f32), k.to(f32).transpose(-1, -2))
    out_c = torch.matmul(torch.softmax(s_c, dim=-1).to(v.dtype), v)
    return torch.cat([out_lat.to(q.dtype), out_c.to(q.dtype)], dim=2)
