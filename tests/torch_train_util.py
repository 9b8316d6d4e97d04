"""Shared helpers of the ``test_torch_train*`` files: one small NCSN++ state
stepped by the JAX package's ``make_train_step`` and by the port's, from one
state carried by ``train_state_from_jax``, with JAX's own draws fed to the
port."""

from __future__ import annotations

import os

import numpy as np
import torch

import torch_port_util as U
from naturaldiffusion_tpu_torch.models.convert import (_flatten,
                                                       train_state_from_jax)
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.sde import VPSDE as TVPSDE
from naturaldiffusion_tpu_torch.train.state import (functional_apply,
                                                    make_train_step)

STEPS, WARMUP, BATCH = 4, 2, 2
# the attention blocks' key bias: the softmax is invariant to it, so its
# gradient is zero in exact arithmetic and rounding noise on both sides,
# which Adam normalises into updates of either sign
ZERO_GRAD = ("NIN_1.b",)


def jax_run(flag: str, *, grad_clip: float, micro: int = 0,
            compute_dtype=None, seed: int = 0):
    """The JAX step ``STEPS`` times at ``NATDIFF_PALLAS_CONV=flag`` (a fresh
    jit: JAX reads it at trace time), in float32 (x64 off).  Returns
    (initial state, final state, losses, draws, batch), the states as numpy
    trees and the draws per step (per chunk with
    ``micro``) as torch tensors."""
    import jax
    import jax.numpy as jnp

    from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JM
    from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JC
    from naturaldiffusion_tpu.sde import VPSDE
    from naturaldiffusion_tpu.train import make_train_step as jmake

    old = os.environ.get("NATDIFF_PALLAS_CONV")
    os.environ["NATDIFF_PALLAS_CONV"] = flag
    try:
        with jax.enable_x64(False):
            jm = JM(config=JC(**U.SMALL))
            params = U.jax_params(jm, jnp.zeros((1, 8, 8, 3)),
                                  jnp.zeros((1,)), seed=seed)
            init, step = jmake(
                VPSDE(), lambda p, x, l: jm.apply({"params": p}, x, l),
                warmup=WARMUP, grad_clip=grad_clip, micro=micro,
                compute_dtype=compute_dtype)
            st = init(jax.tree.map(jnp.asarray, params))
            st0 = jax.device_get(st)
            batch = np.random.default_rng(seed + 3).standard_normal(
                (BATCH, 8, 8, 3)).astype(np.float32)
            keys = [jax.random.PRNGKey(10 + i) for i in range(STEPS)]
            stepj = jax.jit(step)
            losses = []
            for k in keys:
                st, loss = stepj(st, k, jnp.asarray(batch))
                losses.append(float(loss))

            def draw(k, shape):
                kt, kz = jax.random.split(k)
                t = jax.random.uniform(kt, (shape[0],), minval=1e-5,
                                       maxval=1.0)
                z = jax.random.normal(kz, shape)
                return (torch.from_numpy(np.array(t)),
                        torch.from_numpy(np.array(z)))

            if micro and BATCH > micro:
                n = BATCH // micro
                draws = [[draw(kc, (micro, 8, 8, 3))
                          for kc in jax.random.split(k, n)] for k in keys]
            else:
                draws = [draw(k, batch.shape) for k in keys]
            st = jax.device_get(st)
    finally:
        if old is None:
            os.environ.pop("NATDIFF_PALLAS_CONV")
        else:
            os.environ["NATDIFF_PALLAS_CONV"] = old
    return st0, st, losses, draws, batch


def port_run(st0, draws, batch, *, flag: str, grad_clip: float,
             micro: int = 0, compute_dtype=None):
    """The port's step over the same state and draws at
    ``NATDIFF_PALLAS_CONV=flag``; returns (state, losses)."""
    old = os.environ.get("NATDIFF_PALLAS_CONV")
    os.environ["NATDIFF_PALLAS_CONV"] = flag
    try:
        model = NCSNpp(NCSNppConfig(**U.SMALL), device="cpu")
        state = train_state_from_jax(st0, model)
        _, step = make_train_step(TVPSDE(), functional_apply(model),
                                  warmup=WARMUP, grad_clip=grad_clip,
                                  micro=micro, compute_dtype=compute_dtype)
        losses = []
        for d in draws:
            state, loss = step(state, None, torch.from_numpy(batch), draws=d)
            losses.append(float(loss))
    finally:
        if old is None:
            os.environ.pop("NATDIFF_PALLAS_CONV")
        else:
            os.environ["NATDIFF_PALLAS_CONV"] = old
    return state, losses


def _flat(tree) -> dict:
    out: dict = {}
    _flatten(tree, "", out)
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def leaves(state) -> dict:
    """The port state's tensors by part and flax name."""
    names = [n[len("layers."):] for n in state.params]

    def np_(ts):
        return {n: t.detach().double().numpy() for n, t in zip(names, ts)}
    return {"params": np_(state.params.values()),
            "mu": np_(state.opt_state.mu), "nu": np_(state.opt_state.nu),
            "ema": np_(state.ema.shadow)}


def jax_leaves(st) -> dict:
    adam = st.opt_state[1]
    return {"params": _flat(st.params), "mu": _flat(adam.mu),
            "nu": _flat(adam.nu), "ema": _flat(st.ema.shadow)}


def worst(port: dict, want: dict) -> dict:
    """Per part: the largest per-leaf relative L2 over the leaves outside
    ``ZERO_GRAD``, and the relative L2 of all leaves together."""
    out = {}
    for part in want:
        errs = [U.rel_l2(port[part][k], want[part][k]) for k in want[part]
                if not k.endswith(ZERO_GRAD)]
        a = np.concatenate([port[part][k].ravel() for k in want[part]])
        b = np.concatenate([want[part][k].ravel() for k in want[part]])
        out[part] = (max(errs), U.rel_l2(a, b))
    return out


def zero_grad_leaves_ok(port: dict, want: dict, init: dict, lr: float):
    """The ``ZERO_GRAD`` leaves: their moments at the rounding floor on
    both sides, and the parameters within ``STEPS * lr`` of the initial
    values (Adam's largest move) on both sides."""
    for k in want["mu"]:
        if not k.endswith(ZERO_GRAD):
            continue
        for part in ("mu", "nu"):
            assert np.abs(port[part][k]).max() < 1e-8
            assert np.abs(want[part][k]).max() < 1e-8
        for side in (port, want):
            assert np.abs(side["params"][k] - init[k]).max() \
                <= STEPS * lr * 1.01


def global_grad_norm_step1(st0, draws0, batch, flag: str) -> float:
    """|g| of the first step's loss, by the port's plain path."""
    old = os.environ.get("NATDIFF_PALLAS_CONV")
    os.environ["NATDIFF_PALLAS_CONV"] = flag
    try:
        from naturaldiffusion_tpu_torch.train.losses import sde_loss_given
        model = NCSNpp(NCSNppConfig(**U.SMALL), device="cpu")
        state = train_state_from_jax(st0, model)
        t, z = draws0
        loss = sde_loss_given(TVPSDE(), functional_apply(model), state.params,
                              torch.from_numpy(batch), t, z)
        grads = torch.autograd.grad(loss, list(state.params.values()))
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    finally:
        if old is None:
            os.environ.pop("NATDIFF_PALLAS_CONV")
        else:
            os.environ["NATDIFF_PALLAS_CONV"] = old


# f32 both sides, sums in other orders: the loss, parameters and EMA read
# ~2e-7 per leaf.  Adam's moments hold the gradients themselves, whose f32
# rounding floor at this batch of 2 is ~1e-5: each side against a float64
# run of the same 4 steps reads up to 7.8e-6 (mu) and 1.2e-5 (nu) per leaf
# at switch 2, and the two sides 9.5e-6 and 1.4e-5 (1.1e-5 and 1.4e-5 at
# switch 0)
TOL = 1e-5
MOMENT_TOL = 3e-5


def check_state(port, st, st0, part: str, tol: float = TOL,
                moment_tol: float = MOMENT_TOL) -> None:
    """The port's state after ``STEPS`` steps against JAX's: counts, and
    ``part``'s leaves within the part's limit."""
    assert port.step == int(st.step) == STEPS
    assert port.opt_state.count == int(st.opt_state[1].count) == STEPS
    assert port.opt_state.sched_count == int(st.opt_state[2].count)
    assert port.ema.num_updates == int(st.ema.num_updates) == STEPS
    got, want = leaves(port), jax_leaves(st)
    per_leaf, whole = worst(got, want)[part]
    lim = moment_tol if part in ("mu", "nu") else tol
    assert per_leaf < lim and whole < lim, (per_leaf, whole)
    zero_grad_leaves_ok(got, want, _flat(st0.params), 2e-4)
    # the state moved: a check of the steps, not of the initial values
    assert U.rel_l2(want["params"]["m3.Conv_0.kernel"],
                    _flat(st0.params)["m3.Conv_0.kernel"]) > 1e-4
