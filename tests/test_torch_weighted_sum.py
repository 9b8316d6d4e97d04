"""Port's weighted sum (plain version of kernel K1) against the JAX
package's ``weighted_sum_xla`` and its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.weighted_sum import (fused_weighted_sum_pallas,
                                                   weighted_sum_xla)
from naturaldiffusion_tpu_torch.ops.weighted_sum import (
    SPLITS, _ws_plan, fused_weighted_sum, weighted_sum)
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

# f32 sums of <= 16 O(1) terms in another order: ~1e-7 relative, with
# headroom for cancellation near zero
RTOL, ATOL = 1e-6, 1e-6


def test_weighted_sum_matches_xla():
    rng = np.random.default_rng(0)
    w = rng.standard_normal(7).astype(np.float32)
    buf = rng.standard_normal((7, 4, 6, 3)).astype(np.float32)
    want = np.asarray(weighted_sum_xla(jnp.asarray(w), jnp.asarray(buf)))
    got = weighted_sum(torch.from_numpy(w), torch.from_numpy(buf)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("live_x,live_e", [(8, 9), (5, 11), (1, 1), (13, 3)])
def test_fused_weighted_sum_matches_pallas(live_x, live_e):
    """Live counts on and off the TPU kernel's 8-row chunks; weights past
    ``live`` are zero (the NI rows are lower-triangular)."""
    rng = np.random.default_rng(live_x * 100 + live_e)
    nx, ne, m = 16, 16, 384
    wx = rng.standard_normal(nx).astype(np.float32)
    we = rng.standard_normal(ne).astype(np.float32)
    wx[live_x:] = 0.0
    we[live_e:] = 0.0
    bufx = rng.standard_normal((nx, m)).astype(np.float32)
    bufe = rng.standard_normal((ne, m)).astype(np.float32)
    want = np.asarray(fused_weighted_sum_pallas(
        jnp.asarray(wx), jnp.asarray(we), jnp.asarray(bufx),
        jnp.asarray(bufe), live_x, live_e, tile=128, interpret=True))
    full = np.asarray(weighted_sum_xla(jnp.asarray(wx), jnp.asarray(bufx))
                      + weighted_sum_xla(jnp.asarray(we), jnp.asarray(bufe)))
    before = fused_weighted_sum.launches
    got = fused_weighted_sum(*(torch.from_numpy(a) for a in
                               (wx, we, bufx, bufe)), live_x, live_e).numpy()
    assert fused_weighted_sum.launches == before   # CPU: no kernel launch
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


def test_fused_weighted_sum_reads_only_live_rows():
    """Rows at and past ``live`` are never read: NaN there changes nothing."""
    rng = np.random.default_rng(1)
    wx, we = (torch.from_numpy(rng.standard_normal(6).astype(np.float32))
              for _ in range(2))
    bufx = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    bufe = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    want = fused_weighted_sum(wx, we, bufx, bufe, 3, 4)
    bufx[3:] = float("nan")
    bufe[4:] = float("nan")
    got = fused_weighted_sum(wx, we, bufx, bufe, 3, 4)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_weighted_sum_rejects_bad_arguments():
    z = torch.zeros(4, 32)
    w = torch.zeros(4)
    with pytest.raises(ValueError):
        fused_weighted_sum(w, w, z, torch.zeros(4, 16), 1, 1)
    with pytest.raises(ValueError):
        fused_weighted_sum(w, w, z, z, 5, 1)


# --- kernel K1's plan and its order of summation ------------------------------
# csrc/weighted_sum.cu runs on the card only (chip_smoke.py); here its plan
# is walked in Python and its order of summation in torch.

CIFAR_M, DIT_M = 64 * 32 * 32 * 3, 1 * 32 * 32 * 4
# every step of the 10-step CIFAR run and of the 50-step DiT run: step k
# reads k + 1 x rows and min(n + 1, k + 2) eps rows (engine/ni.py)
PLAN_CASES = ([(CIFAR_M, k + 1, min(11, k + 2)) for k in range(10)]
              + [(DIT_M, k + 1, min(51, k + 2)) for k in (0, 3, 24, 49)]
              + [(4, 1, 1), (12, 2, 3), (384, 13, 3), (1 << 22, 7, 0)])


@pytest.mark.parametrize("m,live_x,live_e", PLAN_CASES)
def test_ws_plan_groups_and_columns(m, live_x, live_e):
    """The row groups partition the live rows in order; the blocks' columns
    cover the float4 columns once; the shared memory fits the kernel's."""
    plan = _ws_plan(m, live_x, live_e)
    rows, m4 = live_x + live_e, m // 4
    assert plan["split"] in SPLITS and plan["cols"] * plan["split"] == 256
    assert [g[0] for g in plan["groups"]] == [0] + [g[1] for g in
                                                  plan["groups"][:-1]]
    assert plan["groups"][-1][1] == rows
    assert (plan["blocks"] - 1) * plan["cols"] < m4 <= (plan["blocks"]
                                                        * plan["cols"])
    assert plan["smem"] <= 64 * 1024
    if (m, live_x, live_e) == (CIFAR_M, 10, 11):
        assert plan["split"] == 1
    if (m, live_x, live_e) == (DIT_M, 50, 51):
        assert plan["split"] == 8


def ws_walk(wx, we, bufx, bufe, live_x, live_e, split):
    """K1 in torch, in its order: group g of ``split`` sums its rows in
    order as float32 FMAs (one rounding each) from 0, then the groups add
    in order."""
    w = np.concatenate([wx[:live_x], we[:live_e]]).astype(np.float64)
    rows = np.concatenate([bufx[:live_x], bufe[:live_e]]).astype(np.float64)
    plan_rows = live_x + live_e
    total = None
    for g in range(split):
        acc = np.zeros(bufx.shape[1], np.float32)
        for j in range(g * plan_rows // split, (g + 1) * plan_rows // split):
            acc = (w[j] * rows[j] + acc.astype(np.float64)).astype(np.float32)
        total = acc if total is None else (total + acc).astype(np.float32)
    return total


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("live_x,live_e", [(8, 9), (5, 11), (1, 1), (13, 3)])
def test_ws_walk_matches_pallas(live_x, live_e, split):
    """The kernel's row order at every split against
    ``fused_weighted_sum_pallas(interpret=True)`` and the plain version."""
    rng = np.random.default_rng(live_x * 7 + live_e)
    nx, ne, m = 16, 16, 256
    wx = rng.standard_normal(nx).astype(np.float32)
    we = rng.standard_normal(ne).astype(np.float32)
    wx[live_x:] = 0.0
    we[live_e:] = 0.0
    bufx = rng.standard_normal((nx, m)).astype(np.float32)
    bufe = rng.standard_normal((ne, m)).astype(np.float32)
    want = np.asarray(fused_weighted_sum_pallas(
        jnp.asarray(wx), jnp.asarray(we), jnp.asarray(bufx),
        jnp.asarray(bufe), live_x, live_e, tile=128, interpret=True))
    got = ws_walk(wx, we, bufx, bufe, live_x, live_e, split)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = fused_weighted_sum(*(torch.from_numpy(a) for a in
                                 (wx, we, bufx, bufe)), live_x, live_e)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)
