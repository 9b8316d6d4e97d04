"""The port's train step against the JAX package's: 4 steps (warm-up 2) of a
small NCSN++ (channels that pass ``fused_resblock_ok``, two levels, one
block, attention kept) from one state carried by ``train_state_from_jax``,
JAX's draws fed to the port, under ``NATDIFF_PALLAS_CONV=2`` (JAX's fused
resblock in interpret mode with its XLA recompute VJP; the port's K3, K2 and
K6 Functions on the CPU).  f32; the clip active (``grad_clip`` 1.0 below the
first step's norm).  Limits: ``torch_train_util.TOL`` and ``MOMENT_TOL``."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
import torch_train_util as T

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    st0, st, losses, draws, batch = T.jax_run("2", grad_clip=1.0)
    port, plosses = T.port_run(st0, draws, batch, flag="2", grad_clip=1.0)
    return st0, st, losses, draws, batch, port, plosses


def test_clip_is_active(run):
    st0, _, _, draws, batch, _, _ = run
    assert T.global_grad_norm_step1(st0, draws[0], batch, "2") > 1.0


def test_losses_match(run):
    _, _, losses, _, _, _, plosses = run
    assert np.isfinite(plosses).all()
    np.testing.assert_allclose(plosses, losses, rtol=T.TOL)


@pytest.mark.parametrize("part", ["params", "mu", "nu", "ema"])
def test_state_matches(run, part):
    st0, st, _, _, _, port, _ = run
    T.check_state(port, st, st0, part)
