"""The port's train step with gradient accumulation (``micro=1`` over a
batch of 2: a mean of the chunks' means, one draw set a chunk, JAX's per
chunk draws fed to the port) against the JAX package's, 4 steps from one
carried state under ``NATDIFF_PALLAS_CONV=2``, f32, the clip inactive
(``grad_clip`` 1e6).  See ``test_torch_train_step.py``."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
import torch_train_util as T

torch.set_num_threads(2)
CLIP = 1e6


@pytest.fixture(scope="module")
def run():
    st0, st, losses, draws, batch = T.jax_run("2", grad_clip=CLIP, micro=1)
    port, plosses = T.port_run(st0, draws, batch, flag="2", grad_clip=CLIP,
                               micro=1)
    return st0, st, losses, draws, batch, port, plosses


def test_clip_is_inactive(run):
    st0, _, _, draws, batch, _, _ = run
    # the norm of one chunk's loss, far below the clip
    t, z = draws[0][0]
    assert T.global_grad_norm_step1(st0, (t, z), batch[:1], "2") < CLIP / 10


def test_losses_match(run):
    _, _, losses, _, _, _, plosses = run
    assert len(plosses) == T.STEPS and np.isfinite(plosses).all()
    np.testing.assert_allclose(plosses, losses, rtol=T.TOL)


@pytest.mark.parametrize("part", ["params", "mu", "nu", "ema"])
def test_state_matches(run, part):
    st0, st, _, _, _, port, _ = run
    T.check_state(port, st, st0, part)


def test_micro_must_divide_batch():
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train import make_train_step
    _, step = make_train_step(VPSDE(), lambda p, x, t: x, micro=3)
    with pytest.raises(ValueError, match="must divide"):
        step(None, None, torch.zeros(4, 8, 8, 3))
