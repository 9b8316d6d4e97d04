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
  context]``, its latent block through K10 with the row logsumexp.

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
from ._autograd import inference_only

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 72)
# natdiff_flash_attention(dtype, d, q, k, v, o, s_b, s_h, s_t, o_b, o_h,
# o_t, B, H, T, scale_log2, warps, stages, smem, stream)
_FA_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3
                + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# natdiff_splash_attention(dtype, d, q, k, v, o, lse, s_b, s_h, s_t, o_b,
# o_h, o_t, B, H, T, warps, stages, smem, stream)
_SPLASH_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                    + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])

# --- the kernel's block plan ---------------------------------------------------
# constants of csrc/attention.cu (the entry checks them): keys per tile,
# stages of the bf16 kernel's K/V ring, queries per warp
_BKV, _RING_STAGES, _WARP_ROWS = 64, 3, 16
# blocks a bf16 launch of 8 warps should reach, else it takes 4 warps: two
# per SM of the card's 132
_MIN_BLOCKS_8 = 264
_UNPORTED = {"ring": "ring attention comes with the parallelism slice "
                     "(ROADMAP.md, Queue A, slice 8)"}


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


@functools.lru_cache(maxsize=256)
def _plan_ints(b: int, h: int, t: int, d: int, dtype) -> tuple:
    """:func:`_attn_plan` as the C entries take it, cached: a launch's
    host time counts on the host-bound DiT path."""
    p = _attn_plan(b, h, t, d, dtype)
    return p["warps"], p["stages"], p["smem"]


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


def _check_qkv(q, k, v):
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
            out.data_ptr())
    strides = (st[0], st[1], st[2], out.stride(0), out.stride(2),
               out.stride(1), b, h, t)
    plan = _plan_ints(b, h, t, d, q.dtype)
    with _cuda.on_device(q):
        if sm_scale is None:
            fn = _cuda.entry("attention", "natdiff_splash_attention",
                             _SPLASH_ARGTYPES)
            err = fn(*args, None if res is None else res.data_ptr(),
                     *strides, *plan, _cuda.stream_ptr(q))
        else:
            fn = _cuda.entry("attention", "natdiff_flash_attention",
                             _FA_ARGTYPES)
            err = fn(*args, *strides, sm_scale * math.log2(math.e), *plan,
                     _cuda.stream_ptr(q))
    _cuda.check("attention", err, what)
    return out.transpose(1, 2), res


@inference_only("flash_attention (K9)")
def flash_attention(q, k, v, sm_scale: float):
    """Non-causal attention over ``[B, H, T, D]``, softmax in f32, output in
    q's type.  A CPU tensor takes :func:`mha_reference`; a CUDA tensor takes
    kernel K9 (float32 or bfloat16, D in {16, 32, 64, 72}) or raises.

    q, k and v may be strided views (the DiT splits one qkv tensor
    ``[B, T, 3, H, D]``); the kernel reads them in place when their strides
    allow, else from contiguous copies.  The output is a ``[B, H, T, D]``
    view of a ``[B, T, H, D]`` tensor, so transposing it back to tokens is
    free."""
    _check_qkv(q, k, v)
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
    s = torch.matmul(qs.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2))
    out = torch.matmul(torch.softmax(s, dim=-1),
                       v.to(torch.float32)).to(qs.dtype)
    if not save_residuals:
        return out
    return out, torch.logsumexp(s, dim=-1)


@inference_only("splash_attention (K10)")
def _splash(qs, k, v, save_residuals: bool):
    """K10 on pre-scaled ``qs``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check_qkv(qs, k, v)
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


def mha(q, k, v, *, backend: str = "auto", sm_scale: float | None = None):
    """q/k/v: [B, H, T, D] -> [B, H, T, D]; ``sm_scale`` defaults to
    1/sqrt(D).  ``backend``: ``"auto"`` or ``"flash"`` (kernel K9 on the
    card), ``"splash"`` (kernel K10 on the card), ``"splash_interpret"``
    (K10's plain version on any device, as JAX's interpret mode runs the
    kernel's function without the hardware), ``"xla"`` (the plain einsum
    pair); ``"ring"`` is not ported yet."""
    if backend in _UNPORTED:
        raise NotImplementedError(f"backend={backend!r} is not ported yet: "
                                  f"{_UNPORTED[backend]}")
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
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
