"""GroupNorm (port of ``naturaldiffusion_tpu/ops/group_norm.py``).

* :func:`fused_group_norm` -- the standalone GroupNorm, kernel K6
  (``_gn_body`` via ``group_norm_pallas``, ``:76``/``:126``) behind the
  dispatcher of the same name (``:277``): ``GN(x + extra_bias)``, float32
  statistics with the fast variance ``E[x^2] - E[x]^2``, the affine, an
  optional SiLU, output in x's type.  A CUDA tensor takes the kernel
  (``csrc/group_norm.cu``) at every shape: the JAX gate ``_eligible``
  (``:164``) is a TPU VMEM budget, and the XLA route it leaves the other
  shapes to computes the same function.  A CPU tensor takes
  :func:`fused_group_norm_reference`.  :func:`_gn_plan` picks the kernel's
  form per shape: on-chip (a unit of one sample and a slice of whole groups
  held in the shared memory of a cluster of CTAs), grid (a unit held by the
  whole card's shared memory, one unit after another) or streamed
  (statistics then apply, in chunks that stay in L2).
* :func:`gn_channel_sums` / :func:`gn_affine_coeffs` -- the GroupNorm
  collapsed to per-(sample, channel) scalars, for the fused-resblock
  conv's prologue (``ops.conv3x3.conv3x3_gn``) and for K6's plain version.
* :func:`group_norm_reference` -- the JAX package's plain twin (the
  ``(B, H, W, G, gs)`` reduction), kept as the oracle of the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# natdiff_group_norm(dtype, x, scale, bias, tb, tb_rows, silu, y, scratch,
# B, HW, C, group_size, eps, form, vec_bytes, slice, tile, cluster, samples,
# span, smem, stream)
_GN_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p])

# --- the kernel's plan ---------------------------------------------------------
# constants of csrc/group_norm.cu (its entry checks the plan against them):
# threads a block, loads in flight a thread in the streamed form, the
# portable cluster size
_THREADS, _UNROLL, _MAX_CLUSTER = 256, 4, 8
# shared memory a block may use on the H100; the most a CTA takes and still
# shares its SM with a second one (228 KB an SM, 1 KB of it reserved a CTA)
SMEM_MAX, _SMEM_TWO = 232_448, 115_712
# the H100's SMs: the grid form's blocks where the caller names no card
_SMS = 132
# a cluster widens to fill the card only while each CTA keeps this much x
_MIN_CTA_BYTES = 16 * 1024
# x bytes of a streamed chunk: its apply pass finds them in the 50 MB L2
_L2_CHUNK = 20 * 2 ** 20
# blocks of a streamed chunk's launches
_STREAM_BLOCKS = 4 * _SMS
# the forms, by the number the C entry takes
FORMS = ("onchip", "streamed", "grid")


def _vec_bytes(nbytes: int) -> int:
    """The widest vector (16, 8, 4 or 2 bytes) that divides ``nbytes``."""
    vb = 16
    while nbytes % vb:
        vb //= 2
    return vb


def _red_rows(nq: int) -> int:
    """Rows of the kernel's shared-memory tree for ``nq`` vectors a pixel
    row: the warps where the shuffle step applies (``nq`` divides 32), else
    the block's pixel rows."""
    return _THREADS // 32 if 32 % nq == 0 else _THREADS // nq


def _unit_smem(span: int, cs: int, itemsize: int, nq: int, ncta: int) -> int:
    """Shared memory of an on-chip CTA (``ncta`` > 0) or a grid block
    (``ncta`` = 0) holding ``span`` pixels of ``cs`` channels: the pixels,
    the tree, the cluster's partials, totals, w, b and the extra bias."""
    return (-(-span * cs * itemsize // 16) * 16
            + 4 * (2 * _red_rows(nq) * cs + 2 * ncta * cs + 5 * cs))


def _slices(c: int, gs: int, itemsize: int):
    """(channels, vector bytes, vectors a pixel) of every slice of whole
    groups that divides C and whose pixel row fits a block's threads."""
    out = []
    for cs in range(gs, c + 1, gs):
        if c % cs == 0:
            vb = _vec_bytes(cs * itemsize)
            if cs * itemsize // vb <= _THREADS:
                out.append((cs, vb, cs * itemsize // vb))
    return out


def _onchip_plan(b: int, hw: int, c: int, gs: int, itemsize: int):
    """The on-chip form, or None where one unit exceeds a cluster."""
    slices = _slices(c, gs, itemsize)
    pick = ([s for s in slices if s[1] == 16 and s[0] * itemsize >= 32]
            or [s for s in slices if s[0] * itemsize >= 32] or slices[-1:])
    if not pick:
        return None
    cs, vb, nq = pick[0]

    def smem(k):
        return _unit_smem(-(-hw // k), cs, itemsize, nq, k)
    ncta = next((k for cap in (_SMEM_TWO, SMEM_MAX) for k in (1, 2, 4, 8)
                 if smem(k) <= cap), None)
    if ncta is None:
        return None
    units = b * (c // cs)
    while (ncta < _MAX_CLUSTER and units * ncta < 2 * _SMS
           and -(-hw // (2 * ncta)) * cs * itemsize >= _MIN_CTA_BYTES):
        ncta *= 2
    return dict(form="onchip", vec_bytes=vb, slice=cs, tile=cs, cluster=ncta,
                samples=1, span=-(-hw // ncta), smem=smem(ncta), nq=nq,
                rows=_THREADS // nq, grid=(ncta * (c // cs), b, 1),
                chunks=[(0, b, 0)], scratch=0, launches=1)


def _grid_plan(b: int, hw: int, c: int, gs: int, itemsize: int, sms: int):
    """The grid form, or None where one unit exceeds the grid's shared
    memory: ``sms`` blocks (one an SM), the widest slice of whole groups that
    fits (16-byte vectors first), so the fewest units."""
    span = -(-hw // sms)
    fits = [s for s in _slices(c, gs, itemsize)
            if _unit_smem(span, s[0], itemsize, s[2], 0) <= SMEM_MAX]
    pick = [s for s in fits if s[1] == 16] or fits
    if not pick:
        return None
    cs, vb, nq = pick[-1]
    g = -(-hw // span)
    return dict(form="grid", vec_bytes=vb, slice=cs, tile=cs, cluster=1,
                samples=1, span=span, smem=_unit_smem(span, cs, itemsize, nq,
                                                      0),
                nq=nq, rows=_THREADS // nq, grid=(g, 1, 1),
                chunks=[(bb, 1, c0) for bb in range(b)
                        for c0 in range(0, c, cs)],
                scratch=6 * cs + 1, launches=2)


def _streamed_plan(b: int, hw: int, c: int, gs: int, itemsize: int) -> dict:
    cands = [cs for cs in range(gs, c + 1, gs) if c % cs == 0]
    fit = [cs for cs in cands if hw * cs * itemsize <= _L2_CHUNK]
    cc = fit[-1] if fit else cands[0]
    vb = _vec_bytes(cc * itemsize)
    v = vb // itemsize
    nq = max(d for d in range(1, min(cc // v, 32) + 1) if (cc // v) % d == 0)
    tile = nq * v
    samples = (max(1, min(b, 65535, _L2_CHUNK // (hw * c * itemsize)))
               if cc == c else 1)
    spans = max(1, min(hw, -(-_STREAM_BLOCKS // ((cc // tile) * samples))))
    span = -(-hw // spans)
    chunks = [(b0, min(samples, b - b0), c0) for b0 in range(0, b, samples)
              for c0 in range(0, c, cc)]
    return dict(form="streamed", vec_bytes=vb, slice=cc, tile=tile,
                cluster=1, samples=samples, span=span,
                smem=8 * _red_rows(nq) * tile, nq=nq, rows=_THREADS // nq,
                grid=(-(-hw // span), cc // tile, samples), chunks=chunks,
                scratch=2 * b * c, launches=1 + 2 * len(chunks))


@functools.lru_cache(maxsize=512)
def _gn_plan(b: int, h: int, w: int, c: int, groups: int, itemsize: int,
             form: str | None = None, sms: int = _SMS) -> dict:
    """How kernel K6 covers ``[b, h, w, c]`` with ``groups`` groups of
    elements of ``itemsize`` bytes on a card of ``sms`` SMs.  Pure: the CPU
    tests walk it, and the C entry checks it against its own constants.

    * ``onchip``: a unit is one sample and ``slice`` channels (whole groups,
      the narrowest with 16-byte vectors and >= 32 bytes a pixel where C
      allows), held by a cluster of ``cluster`` CTAs (1-8), each ``span``
      pixels in ``smem`` bytes of shared memory; the cluster is the
      smallest that keeps two CTAs an SM (else one), widened while the grid
      has fewer than two CTAs an SM and each CTA keeps >= 16 KB.  Grid
      ``(cluster * c / slice, b)``, one launch.
    * ``grid``, where a unit exceeds a cluster: ``sms`` blocks, one an SM,
      hold one unit at a time (the widest slice that fits), ``span``
      pixels a block; the units (``chunks``: sample, 1, first channel) in
      order.  A memset of the barrier's counter and one cooperative launch.
    * ``streamed``, where a unit exceeds the grid too: chunks of
      ``samples`` samples x ``slice`` channels (whole groups, <= 20 MB where
      one group allows), each a statistics launch and an apply launch over a
      grid of ``(spans, slice / tile, samples)`` blocks of ``span`` pixels x
      ``tile`` channels, about four blocks an SM; a memset before them.

    ``vec_bytes`` is the vector a thread moves: the widest of 16, 8, 4 and 2
    bytes that divides ``slice * itemsize`` (and so ``c * itemsize``);
    ``nq`` vectors make a pixel's row of a unit or block, ``rows =
    _THREADS // nq`` pixel rows a pass.  ``scratch``: f32 words the wrapper
    allocates.  ``form`` forces one form (for the checks); forcing one
    whose unit does not fit raises."""
    hw = h * w
    if min(b, hw, c, groups, sms) <= 0 or c % groups or itemsize not in (2, 4):
        raise ValueError(f"group_norm: no plan for [{b}, {h}, {w}, {c}] in "
                         f"{groups} groups of {itemsize}-byte elements")
    if form not in (None,) + FORMS:
        raise ValueError(f"unknown form {form!r}")
    gs = c // groups
    for f, make in (("onchip", lambda: _onchip_plan(b, hw, c, gs, itemsize)),
                    ("grid", lambda: _grid_plan(b, hw, c, gs, itemsize,
                                                sms))):
        if form in (None, f):
            plan = make()
            if plan is not None:
                return plan
            if form == f:
                raise ValueError(f"group_norm: a unit of [{b}, {h}, {w}, "
                                 f"{c}] does not fit the {f} form")
    return _streamed_plan(b, hw, c, gs, itemsize)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=512)
def _plan_ints(b, h, w, c, groups, itemsize, form=None, sms=_SMS):
    """:func:`_gn_plan` as the C entry takes it (form, vec_bytes, slice,
    tile, cluster, samples, span, smem), and the scratch words."""
    p = _gn_plan(b, h, w, c, groups, itemsize, form, sms)
    return (FORMS.index(p["form"]), p["vec_bytes"], p["slice"], p["tile"],
            p["cluster"], p["samples"], p["span"], p["smem"]), p["scratch"]


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
    K6 (x float32 or bfloat16) in the form :func:`_gn_plan` picks, or
    raises."""
    _check(x, scale, bias, num_groups, act, extra_bias)
    if x.device.type == "cpu":
        return fused_group_norm_reference(x, scale, bias, num_groups, eps=eps,
                                          act=act, extra_bias=extra_bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the GroupNorm kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    return _launch(x, scale, bias, num_groups, eps, act, extra_bias, None)


def _launch(x, scale, bias, num_groups, eps, act, extra_bias, form):
    """One call of kernel K6 on checked CUDA arguments, in the plan's form
    or in ``form`` (for the checks that run both forms at one shape)."""
    bsz, hh, ww, c = x.shape
    if bsz * hh * ww * c >= 2 ** 31 or bsz > 65535:
        raise ValueError("x too large for the GroupNorm kernel's indexing")
    plan, words = _plan_ints(bsz, hh, ww, c, num_groups, x.element_size(),
                             form, _sm_count(x.device.index))
    x = x.contiguous()
    if x.data_ptr() % 16:              # a view at an odd offset
        x = x.clone()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    tb = (None if extra_bias is None
          else extra_bias.to(torch.float32).contiguous())
    y = torch.empty_like(x)
    scratch = (torch.empty(words, dtype=torch.float32, device=x.device)
               if words else None)
    fn = _cuda.entry("group_norm", "natdiff_group_norm", _GN_ARGTYPES)
    with _cuda.on_device(x):
        err = fn(_DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), None if tb is None else tb.data_ptr(),
                 0 if tb is None else tb.shape[0], act == "silu",
                 y.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 bsz, hh * ww, c, c // num_groups, eps, *plan,
                 _cuda.stream_ptr(x))
    _cuda.check("group_norm", err, "fused_group_norm")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
