"""Port's weighted sum (plain version of kernel K1) against the JAX
package's ``weighted_sum_xla`` and its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.ops.weighted_sum import (fused_weighted_sum_pallas,
                                                   weighted_sum_xla)
from naturaldiffusion_tpu_torch.ops.weighted_sum import (
    fused_weighted_sum, weighted_sum)

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
