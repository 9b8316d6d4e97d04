"""Device meshes and shardings over ``torch.distributed`` (port of
``naturaldiffusion_tpu/parallel/mesh.py``).

JAX names a mesh of devices and places arrays on it by ``PartitionSpec``s;
XLA inserts the collectives.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group (one
rank a device), a sharding is a :class:`NamedSharding` that maps a
``PartitionSpec``-like tuple onto DTensor placements (``Shard(dim)`` on
the mesh axes the spec names, ``Replicate()`` on the others), and the
collectives are DTensor's redistributions or explicit ``torch.distributed``
calls.

* :func:`make_mesh` -- a ``DeviceMesh`` over the initialised process group;
  without one it makes a 1-rank group in this process (NCCL for ``cuda``,
  gloo for ``cpu``) on an in-memory store, so no port is bound.  NCCL
  takes one rank a card: on one card the mesh has 1 rank and every
  collective is a no-op.
* :func:`named`, :func:`replicated`, :func:`batch_sharding`,
  :func:`shard_batch` -- shardings and the placement of a host batch (each
  rank keeps its own slice of the same global batch, no communication).
* :func:`fold_in_shard` -- the per-shard random stream of DP sampling: a
  ``torch.Generator`` seeded from ``(seed, index on the axis)`` in place of
  ``jax.random.fold_in(key, axis_index)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (
    implicit_replication as _implicit_replication)

from ..device import resolve_device


def implicit_replication():
    """DTensor's implicit replication of plain tensors (they count as
    replicated in an op with DTensors), safe to nest: torch's own context
    switches it off on leaving, also when an outer one is still open."""
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return _implicit_replication()


def ensure_process_group(device="cuda") -> None:
    """Initialise a 1-rank process group in this process when none is: NCCL
    for a CUDA device, gloo for the CPU, on a ``HashStore``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(axes: dict[str, int] | None = None,
              device="cuda") -> DeviceMesh:
    """``make_mesh({"data": 2, "model": 2})``; by default a 1-D ``data``
    mesh over every rank.  Initialises a 1-rank group first when there is
    none (:func:`ensure_process_group`).  A CUDA mesh puts rank r on card
    ``r % device_count``."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if axes is None:
        axes = {"data": n}
    shape = tuple(int(v) for v in axes.values())
    if math.prod(shape) != n:
        raise ValueError(f"mesh {axes} needs {math.prod(shape)} ranks, the "
                         f"process group has {n}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def placements(mesh: DeviceMesh, spec) -> tuple:
    """DTensor placements of a PartitionSpec-like ``spec`` (one entry a
    tensor dim: an axis name, a tuple of names, or None): ``Shard(dim)`` on
    each mesh axis that dim names, ``Replicate()`` on the others."""
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            i = mesh.mesh_dim_names.index(name)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {name!r} named twice in {spec}")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a PartitionSpec-like
    ``spec``; ``placements`` are DTensor's."""
    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def distribute(self, x: torch.Tensor) -> DTensor:
        """The DTensor of the global ``x`` (the same on every rank) under
        this sharding: each rank keeps its own slice, no communication."""
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)

    def constrain(self, x):
        """``with_sharding_constraint``: a DTensor redistributed to this
        sharding, a plain tensor distributed."""
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return self.distribute(x)


def named(mesh: DeviceMesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: DeviceMesh, ndim: int,
                   axis: str = "data") -> NamedSharding:
    """Shard dim 0 (batch) over ``axis``, replicate the rest."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def shard_batch(mesh: DeviceMesh, tree, axis: str = "data"):
    """A host batch (a tensor, or a dict / list / tuple of them) as
    DTensors sharded on dim 0 over ``axis``; every rank passes the same
    global batch and keeps its slice."""
    if isinstance(tree, torch.Tensor):
        return batch_sharding(mesh, tree.dim(), axis).distribute(tree)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    return type(tree)(shard_batch(mesh, v, axis) for v in tree)


def local_rows(x: torch.Tensor, mesh: DeviceMesh,
               axis: str = "data") -> torch.Tensor:
    """This rank's rows of the global ``x`` on ``axis`` (dim 0 split in
    equal parts), as ``shard_batch`` would place them, as a plain tensor."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                         f"{axis!r} axis's {n} ranks")
    i = axis_index(mesh, axis)
    return x.chunk(n)[i]


def fold_in_shard(seed: int, mesh: DeviceMesh, axis: str = "data",
                  device="cpu") -> torch.Generator:
    """A generator for this rank's shard: seeded from ``(seed, index on
    axis)``, so the ranks of ``axis`` draw different, reproducible streams
    (``jax.random.fold_in(key, axis_index(axis))``)."""
    idx = axis_index(mesh, axis)
    g = torch.Generator(device=device)
    return g.manual_seed((int(seed) * 1_000_003 + idx) % (2 ** 63))
