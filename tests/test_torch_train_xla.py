"""The port's train step under ``NATDIFF_PALLAS_CONV=0`` (the library convs
and K6's Function) against the JAX package's (XLA convs and GroupNorm), 4
steps from one carried state with gradient accumulation (``micro=1``), f32,
the clip active.  See ``test_torch_train_step.py``."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
import torch_train_util as T

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    st0, st, losses, draws, batch = T.jax_run("0", grad_clip=1.0, micro=1)
    port, plosses = T.port_run(st0, draws, batch, flag="0", grad_clip=1.0,
                               micro=1)
    return st0, st, losses, draws, batch, port, plosses


def test_clip_is_active(run):
    st0, _, _, draws, batch, _, _ = run
    assert T.global_grad_norm_step1(st0, draws[0][0], batch[:1], "0") > 1.0


def test_losses_match(run):
    _, _, losses, _, _, _, plosses = run
    assert np.isfinite(plosses).all()
    np.testing.assert_allclose(plosses, losses, rtol=T.TOL)


@pytest.mark.parametrize("part", ["params", "mu", "nu", "ema"])
def test_state_matches(run, part):
    st0, st, _, _, _, port, _ = run
    T.check_state(port, st, st0, part)
