"""Ring attention: sequence-parallel attention over a mesh axis (port of
``naturaldiffusion_tpu/ops/ring_attention.py``).

With the token axis sharded over ``axis``, full attention would gather K and
V.  Ring attention keeps them sharded: each rank computes its queries
against the K/V block it holds, passes the block to the next rank of the
ring and takes the previous rank's (``dist.batch_isend_irecv`` in the
axis's sub-group, ``n - 1`` times), and merges the blocks by the same f32
online logsumexp as JAX's (``_local_block``: the products in the input
type, then float32).  Peak memory is O(T / n) a rank.  JAX's ring has no
Pallas kernel, and neither has this one: the block products are
``torch.matmul``.

It is differentiable, as JAX's is through ``ppermute``: the forward keeps
the f32 row logsumexp, and the backward runs the ring again.  Each rank
recomputes its queries' probabilities against every K/V block from that
logsumexp, adds to its own dq, and adds to the block's dk and dv, which
travel round the ring with their block (``n`` rotations) and so come back
to the rank that holds it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..parallel.mesh import NamedSharding, axis_index, axis_size


def _local_block(q, k, v, sm_scale):
    """Scores and per-row (max, sum of exp, exp-weighted V) of one K/V
    block; the products in the input type, the softmax parts in f32."""
    s = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) * sm_scale
    m = s.amax(dim=-1)                                     # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype), v)
    return m, l, o.to(torch.float32)


def _rotate(tensors, ring):
    """Send each of ``tensors`` to the next rank of the ring and receive
    the previous rank's, as one batch of point-to-point transfers."""
    group, nxt, prv = ring
    got = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, g in zip(tensors, got):
        ops += [dist.P2POp(dist.isend, t, nxt, group),
                dist.P2POp(dist.irecv, g, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _ring_of(mesh, axis: str):
    """(the axis's group, the next and the previous rank as global
    ranks)."""
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    r = axis_index(mesh, axis)
    return (group, dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


class _RingFn(torch.autograd.Function):
    """The ring on this rank's local blocks (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, sm_scale):
        n = axis_size(mesh, axis)
        ring = _ring_of(mesh, axis) if n > 1 else None
        m, l, o = _local_block(q, k, v, sm_scale)
        kk, vv = k.contiguous(), v.contiguous()
        for _ in range(n - 1):
            kk, vv = _rotate([kk, vv], ring)
            m2, l2, o2 = _local_block(q, kk, vv, sm_scale)
            m_new = torch.maximum(m, m2)
            a, b = torch.exp(m - m_new), torch.exp(m2 - m_new)
            l = l * a + l2 * b
            o = o * a[..., None] + o2 * b[..., None]
            m = m_new
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring, ctx.n, ctx.sm_scale = ring, n, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, n, scale = ctx.ring, ctx.n, ctx.sm_scale
        do = dout.to(v.dtype)
        delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kk, vv = k.contiguous(), v.contiguous()
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            s = torch.matmul(q, kk.transpose(-1, -2)).to(torch.float32)
            p = torch.exp(s * scale - lse[..., None])
            dv += torch.matmul(p.to(v.dtype).transpose(-1, -2), do).to(
                torch.float32)
            dp = torch.matmul(do, vv.transpose(-1, -2)).to(torch.float32)
            ds = (p * (dp - delta[..., None])).to(q.dtype)
            dq += torch.matmul(ds, kk).to(torch.float32) * scale
            dk += torch.matmul(ds.transpose(-1, -2), q).to(
                torch.float32) * scale
            if n > 1:
                # the block's dk and dv travel with it; after the n-th
                # rotation they are home and the block is no longer needed
                if step < n - 1:
                    kk, vv, dk, dv = _rotate([kk, vv, dk, dv], ring)
                else:
                    dk, dv = _rotate([dk, dv], ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_local(q, k, v, mesh, axis: str, sm_scale: float):
    """The ring on this rank's local ``[B, H, T/n, D]`` blocks; returns
    this rank's output block.  Differentiable in q, k and v."""
    return _RingFn.apply(q, k, v, mesh, axis, sm_scale)


def _sharded(x, spec: NamedSharding):
    """``x`` as a DTensor under ``spec``: a DTensor redistributed, a plain
    tensor (the same global value on every rank) taken as replicated and
    then split, so its gradient comes back gathered, the whole gradient
    on every rank."""
    if isinstance(x, DTensor):
        return spec.constrain(x)
    rep = DTensor.from_local(x, spec.mesh, [Replicate()] * spec.mesh.ndim,
                             run_check=False)
    return rep.redistribute(spec.mesh, spec.placements)


def ring_mha(q, k, v, mesh, *, axis: str = "model",
             sm_scale: float | None = None):
    """q/k/v: ``[B, H, T, D]``, full (non-causal) attention with T sharded
    over ``axis``.  DTensors are redistributed to (T over ``axis``, the
    rest replicated) and the output is that DTensor; plain tensors (the
    same global value on every rank) are sharded here and the output
    gathered back to a plain tensor.  Gradients return to each input in
    its own placements (a plain tensor's whole, on every rank)."""
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(f"ring attention needs T ({q.shape[2]}) a multiple "
                         f"of the {axis!r} axis's {n} ranks")
    spec = NamedSharding(mesh, (None, None, axis, None))
    dt = isinstance(q, DTensor)
    q, k, v = (_sharded(a, spec) for a in (q, k, v))
    out = ring_local(q.to_local(), k.to_local(), v.to_local(), mesh, axis,
                     sm_scale)
    out = DTensor.from_local(out, mesh, spec.placements, run_check=False)
    return out if dt else out.full_tensor()
