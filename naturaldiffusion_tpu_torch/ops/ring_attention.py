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

Forward only: the point-to-point transfers carry no gradient (JAX's
``ppermute`` does), so under grad mode it raises.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def _rotate(k, v, group, nxt: int, prv: int):
    """Send ``k``, ``v`` to ``nxt`` and receive the block of ``prv`` (global
    ranks), as one batch of point-to-point transfers."""
    k2, v2 = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, nxt, group),
           dist.P2POp(dist.irecv, k2, prv, group),
           dist.P2POp(dist.isend, v, nxt, group),
           dist.P2POp(dist.irecv, v2, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k2, v2


def ring_local(q, k, v, mesh, axis: str, sm_scale: float):
    """The ring on this rank's local ``[B, H, T/n, D]`` blocks; returns
    this rank's output block."""
    n = axis_size(mesh, axis)
    m, l, o = _local_block(q, k, v, sm_scale)
    if n > 1:
        group = mesh.get_group(axis)
        r = axis_index(mesh, axis)
        nxt = dist.get_global_rank(group, (r + 1) % n)
        prv = dist.get_global_rank(group, (r - 1) % n)
        k, v = k.contiguous(), v.contiguous()
        for _ in range(n - 1):
            k, v = _rotate(k, v, group, nxt, prv)
            m2, l2, o2 = _local_block(q, k, v, sm_scale)
            m_new = torch.maximum(m, m2)
            a, b = torch.exp(m - m_new), torch.exp(m2 - m_new)
            l = l * a + l2 * b
            o = o * a[..., None] + o2 * b[..., None]
            m = m_new
    return (o / l[..., None]).to(q.dtype)


def ring_mha(q, k, v, mesh, *, axis: str = "model",
             sm_scale: float | None = None):
    """q/k/v: ``[B, H, T, D]``, full (non-causal) attention with T sharded
    over ``axis``.  DTensors are redistributed to (T over ``axis``, the
    rest replicated) and the output is that DTensor; plain tensors (the
    same global value on every rank) are sharded here and the output
    gathered back to a plain tensor."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise NotImplementedError(
            "ring attention has no gradient in the port (its transfers "
            "are point-to-point sends); run it under torch.no_grad()")
    d = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(f"ring attention needs T ({q.shape[2]}) a multiple "
                         f"of the {axis!r} axis's {n} ranks")
    spec = NamedSharding(mesh, (None, None, axis, None))
    dt = isinstance(q, DTensor)
    q, k, v = (spec.constrain(a) for a in (q, k, v))
    out = ring_local(q.to_local(), k.to_local(), v.to_local(), mesh, axis,
                     sm_scale)
    out = DTensor.from_local(out, mesh, spec.placements, run_check=False)
    return out if dt else out.full_tensor()
