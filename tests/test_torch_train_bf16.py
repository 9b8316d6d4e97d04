"""The port's mixed-precision train step (``compute_dtype=torch.bfloat16``:
the parameters cast per step, float32 masters, grads and loss) against the
JAX package's, 4 steps from one carried state, the clip active.

JAX's bf16 step runs under ``NATDIFF_PALLAS_CONV=0``: under ``2`` its fused
resblock's VJP raises on the CPU (``conv_general_dilated`` of a bf16 input
with float32 accumulation has no transpose for mixed types).  So the port's
bf16 step at switches 0 and 2 goes against JAX's bf16 step at 0, within 1.5x
the control, JAX's bf16 state against its own f32 state (measured: params
3.1e-4, mu 1.8e-2, nu 1.1e-2, EMA 2.6e-4 over all leaves; the port read
3.1-3.2e-4, 1.7-1.8e-2, 0.74-0.85e-2, 2.6-2.7e-4).  The f32 step at switch
0 without ``micro`` is held to 1e-5 beside it."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
import torch_train_util as T

torch.set_num_threads(2)
PARTS = ("params", "mu", "nu", "ema")
FACTOR = 1.5


@pytest.fixture(scope="module")
def jax_runs():
    import jax.numpy as jnp
    bf = T.jax_run("0", grad_clip=1.0, compute_dtype=jnp.bfloat16)
    f32 = T.jax_run("0", grad_clip=1.0)
    return bf, f32


@pytest.mark.parametrize("flag", ["0", "2"])
def test_bf16_step_within_control(jax_runs, flag):
    (st0, st, losses, draws, batch), (_, stf, _, _, _) = jax_runs
    port, plosses = T.port_run(st0, draws, batch, flag=flag, grad_clip=1.0,
                               compute_dtype=torch.bfloat16)
    assert port.step == T.STEPS and np.isfinite(plosses).all()
    assert all(v.dtype == torch.float32 for v in port.params.values())
    got, want = T.worst(T.leaves(port), T.jax_leaves(st)), T.worst(
        T.jax_leaves(st), T.jax_leaves(stf))
    for part in PARTS:
        assert got[part][1] < FACTOR * want[part][1], (part, got, want)
    np.testing.assert_allclose(plosses, losses, rtol=2e-3)


@pytest.mark.parametrize("part", PARTS)
def test_f32_step_switch0(jax_runs, part):
    _, (st0, st, losses, draws, batch) = jax_runs
    port, plosses = T.port_run(st0, draws, batch, flag="0", grad_clip=1.0)
    np.testing.assert_allclose(plosses, losses, rtol=T.TOL)
    T.check_state(port, st, st0, part)
