"""The train state and the step factory (port of
``naturaldiffusion_tpu/train/state.py``: the reference's ``get_step_fn``,
``deps/score_sde_pytorch/losses.py:151-210`` and ``run_lib.py:104-145``).

The step updates the parameters, Adam's moments and the EMA shadow in
place, the counterpart of the JAX step's donated buffers: one copy of the
state lives on the card.

On a mesh (JAX shards the step by its inputs' shardings; here the step
reads them):

* **DTensor parameters** (TP, ``parallel.dit_tp_sharding``) with a
  batch-sharded DTensor batch (``parallel.shard_batch``): the loss is the
  global batch's, computed on DTensors; each gradient is redistributed to
  its parameter's placements, which sums the data shards' partial
  gradients of the global mean.
* **DP** (``mesh=``, a plain global batch, the same on every rank): each
  rank takes its rows of the batch and of the global draws, and the loss
  and gradients are averaged over ``data_axis`` explicitly, one all-reduce
  of one flat buffer; they equal the replicated step's.
* **FSDP** (``mesh=`` and a state placed by ``parallel.fsdp_sharding``):
  the parameters, moments and EMA live as DTensor shards over
  ``data_axis``; the step gathers the parameters for the forward and
  reduce-scatters the averaged gradients onto the shards, and the
  optimizer and the EMA update the shards in place.

Where the state is DTensors (TP, FSDP), the optimizer and the EMA update
each rank's local shards in place (``torch._foreach_*`` on the local
tensors: on DTensors every foreach op pays DTensor's dispatch a leaf), the
clip reading the global gradient norm (:func:`grad_norm`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ..ops._autograd import is_dtensor
from .ema import EMA
from .losses import OptState, make_optimizer, sde_draws, sde_loss_given


@dataclasses.dataclass
class TrainState:
    """``params``: name -> tensor (leaves that require grad, e.g. a model's
    ``dict(named_parameters())``); ``opt_state`` and ``ema`` hold their
    tensors in the order of ``params``."""
    step: int
    params: dict
    opt_state: OptState
    ema: EMA

    @classmethod
    def create(cls, params: dict, tx, ema_decay: float = 0.9999):
        return cls(step=0, params=params,
                   opt_state=tx.init(params.values()),
                   ema=EMA.create(params.values(), decay=ema_decay))


def functional_apply(model: torch.nn.Module) -> Callable:
    """``apply_fn(params, x, label)`` over ``model`` with the tensors of
    ``params`` (name -> tensor) in place of its own:
    ``torch.func.functional_call``."""
    def apply_fn(params, x, label):
        return torch.func.functional_call(model, params, (x, label))
    return apply_fn


def _dtensors(tensors) -> bool:
    return any(is_dtensor(t) for t in tensors)


def _on_dtensors(tensors):
    """Implicit replication of plain tensors where DTensors take part."""
    if not _dtensors(tensors):
        return contextlib.nullcontext()
    from ..parallel.mesh import implicit_replication
    return implicit_replication()


def _local(ts) -> list:
    """Each DTensor's local shard (the same storage), other tensors as
    they are; call under ``no_grad`` for in-place use."""
    return [t.to_local() if is_dtensor(t) else t for t in ts]


def grad_norm(grads):
    """The global L2 norm of ``grads``: a DTensor's local squares summed
    over the mesh dims it is sharded on (one all-reduce a placement)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    groups, plain = {}, []
    for g in grads:
        if is_dtensor(g):
            groups.setdefault((g.device_mesh, tuple(g.placements)),
                              []).append(g.to_local())
        else:
            plain.append(g)
    sq = [torch.stack(torch._foreach_norm(plain)).square().sum()] \
        if plain else []
    for (mesh, pl), loc in groups.items():
        part = torch.stack(torch._foreach_norm(loc)).square().sum()
        if any(isinstance(p, Shard) for p in pl):
            part = DTensor.from_local(part, mesh, [
                Partial() if isinstance(p, Shard) else Replicate()
                for p in pl], run_check=False).full_tensor()
        sq.append(part)
    return torch.sqrt(torch.stack(sq).sum())


def average_over(tensors: list, mesh, axis: str) -> list:
    """The mean of each tensor over the ranks of ``axis``: one all-reduce
    of one flat buffer (a no-op on a 1-rank axis)."""
    import torch.distributed as dist
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return tensors
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=mesh.get_group(axis))
    flat /= n
    return list(torch._utils._unflatten_dense_tensors(flat, tensors))


def scatter_mean(grad: torch.Tensor, param, axis: str):
    """FSDP: this rank's gradient of the local batch, averaged over
    ``axis`` onto ``param``'s placements (a reduce-scatter where the
    parameter is sharded, an all-reduce where it is replicated)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = param.device_mesh
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    partial = [Partial() if name == axis else Replicate()
               for name in mesh.mesh_dim_names]
    return DTensor.from_local(grad / n, mesh, partial,
                              run_check=False).redistribute(
        mesh, param.placements)


def make_train_step(sde, apply_fn: Callable, *, lr: float = 2e-4,
                    warmup: int = 5000, grad_clip: float = 1.0,
                    reduce_mean: bool = True,
                    likelihood_weighting: bool = False,
                    continuous: bool = True,
                    remat: bool = False,
                    compute_dtype: torch.dtype | None = None,
                    micro: int = 0, mesh=None, data_axis: str = "data"):
    """Returns ``(init_fn(params) -> TrainState, step_fn(state, generator,
    batch, draws=None) -> (state, loss))``; ``apply_fn(params, x, label)``
    is the network (:func:`functional_apply`).

    * ``compute_dtype=torch.bfloat16``: mixed precision, as in JAX: the
      parameters are cast per step (the grads arrive in float32 on the
      float32 masters), the input cast, the output and the loss float32.
    * ``remat``: the network under ``torch.utils.checkpoint``
      (activations recomputed in the backward).
    * ``micro=M``: gradient accumulation over M-sample chunks, the mean of
      the chunks' mean losses and grads, one draw set a chunk.
    * ``draws``: ``(t, z)`` (a list of them, one a chunk, with ``micro``)
      instead of draws from ``generator``, so a test can feed JAX's.
    * ``mesh``: DP over ``data_axis``, and FSDP when the state's
      parameters are sharded over it (see the module docstring).  A
      DTensor batch needs no ``mesh``: the step runs on DTensors.

    The loss is a float32 tensor on the batch's device (no host read)."""
    if mesh is not None and micro:
        raise ValueError("micro-batches and a mesh do not combine")
    tx = make_optimizer(lr=lr, warmup=warmup, grad_clip=grad_clip)
    net = apply_fn
    if compute_dtype is not None:
        def net(p_, x, label):
            p_lo = {k: v.to(compute_dtype) for k, v in p_.items()}
            return apply_fn(p_lo, x.to(compute_dtype), label).to(
                torch.float32)
    if remat:
        inner = net

        def net(p_, x, label):
            return torch.utils.checkpoint.checkpoint(
                lambda x_, l_: inner(p_, x_, l_), x, label,
                use_reentrant=False)

    def init_fn(params: dict) -> TrainState:
        return TrainState.create(params, tx)

    def loss_and_grads(params, batch, generator, draws):
        t, z = draws if draws is not None else sde_draws(sde, batch,
                                                         generator)
        with torch.enable_grad(), _on_dtensors([batch, *params.values()]):
            loss = sde_loss_given(sde, net, params, batch, t, z,
                                  reduce_mean=reduce_mean,
                                  likelihood_weighting=likelihood_weighting,
                                  continuous=continuous)
            if is_dtensor(loss):
                loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, list(params.values()))
        # a DTensor gradient onto its parameter's placements: the data
        # shards' partial sums of the global mean's gradient are added
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(g) and g.placements != p.placements
                 else g for g, p in zip(grads, params.values())]
        return loss.detach(), grads

    def mesh_loss_and_grads(state, generator, batch, draws):
        """DP / FSDP: this rank's rows of the global batch and draws, the
        loss and gradients averaged over the data axis."""
        from ..parallel.mesh import local_rows
        t, z = draws if draws is not None else sde_draws(sde, batch,
                                                         generator)
        rows = [local_rows(a, mesh, data_axis) for a in (batch, t, z)]
        names = list(state.params)
        sharded = _dtensors(state.params.values())
        params = state.params
        if sharded:         # FSDP: the forward takes gathered parameters
            params = {k: v.full_tensor().detach().requires_grad_()
                      for k, v in state.params.items()}
        loss, grads = loss_and_grads(params, rows[0], None, tuple(rows[1:]))
        if sharded:
            loss = average_over([loss], mesh, data_axis)[0]
            grads = [scatter_mean(g, state.params[k], data_axis)
                     for g, k in zip(grads, names)]
        else:
            loss, *grads = average_over([loss, *grads], mesh, data_axis)
        return loss, grads

    def step_fn(state: TrainState, generator: torch.Generator | None, batch,
                draws: Any = None):
        if mesh is not None and not is_dtensor(batch):
            loss, grads = mesh_loss_and_grads(state, generator, batch, draws)
        elif micro and batch.shape[0] > micro:
            if batch.shape[0] % micro:
                raise ValueError(
                    f"micro={micro} must divide batch {batch.shape[0]}")
            n = batch.shape[0] // micro
            lsum, gsum = None, None
            for i, chunk in enumerate(batch.split(micro)):
                loss, grads = loss_and_grads(
                    state.params, chunk, generator,
                    None if draws is None else draws[i])
                loss = loss.to(torch.float32)
                if gsum is None:
                    lsum, gsum = loss, grads
                else:
                    lsum = lsum + loss
                    torch._foreach_add_(gsum, grads)
            loss = lsum / n
            grads = torch._foreach_div(gsum, float(n))
        else:
            loss, grads = loss_and_grads(state.params, batch, generator,
                                         draws)
        params = list(state.params.values())
        if not _dtensors(params):
            tx.update(params, grads, state.opt_state)
            state.ema.update(params)
        else:           # each rank's shards, in place
            norm = grad_norm(grads) if tx.grad_clip > 0 else None
            with torch.no_grad():
                opt, ema = state.opt_state, state.ema
                lopt = dataclasses.replace(opt, mu=_local(opt.mu),
                                           nu=_local(opt.nu))
                lema = dataclasses.replace(ema, shadow=_local(ema.shadow))
                lp = _local(params)
                tx.update(lp, _local(grads), lopt, grad_norm=norm)
                lema.update(lp)
            opt.count, opt.sched_count = lopt.count, lopt.sched_count
            ema.num_updates = lema.num_updates
        state.step += 1
        return state, loss

    return init_fn, step_fn
