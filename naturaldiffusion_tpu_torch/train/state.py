"""The train state and the step factory (port of
``naturaldiffusion_tpu/train/state.py``: the reference's ``get_step_fn``,
``deps/score_sde_pytorch/losses.py:151-210`` and ``run_lib.py:104-145``).

The step updates the parameters, Adam's moments and the EMA shadow in
place, the counterpart of the JAX step's donated buffers: one copy of the
state lives on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.utils.checkpoint

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


def make_train_step(sde, apply_fn: Callable, *, lr: float = 2e-4,
                    warmup: int = 5000, grad_clip: float = 1.0,
                    reduce_mean: bool = True,
                    likelihood_weighting: bool = False,
                    continuous: bool = True,
                    remat: bool = False,
                    compute_dtype: torch.dtype | None = None,
                    micro: int = 0):
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

    The loss is a float32 tensor on the batch's device (no host read)."""
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
        with torch.enable_grad():
            loss = sde_loss_given(sde, net, params, batch, t, z,
                                  reduce_mean=reduce_mean,
                                  likelihood_weighting=likelihood_weighting,
                                  continuous=continuous)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), list(grads)

    def step_fn(state: TrainState, generator: torch.Generator | None, batch,
                draws: Any = None):
        if micro and batch.shape[0] > micro:
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
        tx.update(params, grads, state.opt_state)
        state.ema.update(params)
        state.step += 1
        return state, loss

    return init_fn, step_fn
