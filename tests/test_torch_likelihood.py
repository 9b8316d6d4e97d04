"""The port's probability-flow likelihood against the JAX package's in
float64 with one probe (JAX's Rademacher or Gaussian draw fed to the port):
bits/dim, the latent and the number of calls over one smooth network
written in each package; the port's reverse-mode Hutchinson divergence
through a small NCSN++ on the kernels' Functions against JAX's forward
mode; the divergence against the exact trace of a linear drift.  Also
DiT's label dropout with JAX's mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from naturaldiffusion_tpu.eval import likelihood as jlik
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JM
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JC
from naturaldiffusion_tpu.sde import VPSDE as JVPSDE
from naturaldiffusion_tpu.sde import get_score_fn as jscore
from naturaldiffusion_tpu_torch.eval import likelihood as tlik
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

torch.set_num_threads(2)
# float64 on both sides, the same RK45 steps: agreement to ~1e-12 expected
TOL = 1e-8


def test_divergence_is_the_trace():
    """A linear drift ``x A``: ``eps^T J eps`` summed over many Gaussian
    probes approaches trace(A) per sample; one Rademacher probe with A
    diagonal gives the trace exactly."""
    a = torch.diag(torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64))
    div = tlik.get_div_fn(lambda x, t: x @ a)
    x = torch.randn(4, 3, dtype=torch.float64)
    probe = torch.randint(0, 2, (4, 3)).double() * 2 - 1
    np.testing.assert_allclose(div(x, None, probe).numpy(), [-0.5] * 4)


def _mix(seed=0):
    return np.random.default_rng(seed).standard_normal((3, 3)) * 0.5


@pytest.mark.parametrize("hutchinson", ["rademacher", "gaussian"])
def test_likelihood_matches_jax_float64(hutchinson):
    """The whole likelihood (RK45 over the augmented ODE, the probe's
    divergence, the prior, the offset) in float64 on both sides over one
    smooth eps-network written in each package (channel mixing, tanh, the
    label): the same steps, bits/dim and latent to rounding."""
    w = _mix()
    data = np.random.default_rng(1).uniform(-1, 1, (2, 4, 4, 3))
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jw = jnp.asarray(w)
        sfn = jscore(JVPSDE(), lambda x, lab: jnp.tanh(
            x @ jw + 1e-3 * lab[:, None, None, None]))
        lik = jlik.get_likelihood_fn(JVPSDE(), sfn,
                                     hutchinson_type=hutchinson,
                                     rtol=1e-5, atol=1e-5,
                                     inverse_scaler=get_inverse_scaler(True))
        bpd, z, nfe = lik(key, jnp.asarray(data))
        probe = (jax.random.rademacher(key, data.shape, dtype=jnp.float64)
                 if hutchinson == "rademacher"
                 else jax.random.normal(key, data.shape, jnp.float64))
    tw = torch.from_numpy(w)
    tfn = get_score_fn(VPSDE(), lambda x, lab: torch.tanh(
        x @ tw + 1e-3 * lab[:, None, None, None]))
    tl = tlik.get_likelihood_fn(VPSDE(), tfn, hutchinson_type=hutchinson,
                                rtol=1e-5, atol=1e-5,
                                inverse_scaler=get_inverse_scaler(True))
    gbpd, gz, gnfe = tl(None, torch.from_numpy(data),
                        probe=torch.from_numpy(np.array(probe)))
    assert gnfe == int(nfe) and gnfe > 7
    np.testing.assert_allclose(gbpd.numpy(), np.asarray(bpd), rtol=TOL)
    assert U.rel_l2(gz.numpy(), np.asarray(z)) < TOL
    assert np.isfinite(gbpd.numpy()).all()


def test_divergence_through_the_kernels_matches_jax():
    """The port's reverse-mode divergence of the probability-flow drift
    through a small NCSN++ on the fused path (K3, K2, K6 Functions) against
    JAX's forward mode under its XLA convs, one probe, at two times.  Both
    models keep their GroupNorms in float32 (JAX's too under x64), so the
    limit is the f32 floor, 1e-5."""
    jm = JM(config=JC(**U.SMALL))
    params = U.jax_params(jm, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))
    tm = load_jax_params(NCSNpp(NCSNppConfig(**U.SMALL), device="cpu"),
                         params).double()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 8, 8, 3))
    probe = np.sign(rng.standard_normal(x.shape))
    tsfn = get_score_fn(VPSDE(), tm)
    trs = VPSDE().reverse(tsfn, probability_flow=True)
    tdiv = tlik.get_div_fn(lambda y, t: trs.sde(y, t)[0])
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        sfn = jscore(JVPSDE(), lambda y, t: jm.apply({"params": jp}, y, t))
        rsde = JVPSDE().reverse(sfn, probability_flow=True)
        jdiv = jlik.get_div_fn(lambda y, t: rsde.sde(y, t)[0])
        for t in (0.3, 0.9):
            want = np.asarray(jdiv(jnp.asarray(x), jnp.full((2,), t),
                                   jnp.asarray(probe)))
            got = tdiv(torch.from_numpy(x),
                       torch.full((2,), t, dtype=torch.float64),
                       torch.from_numpy(probe)).numpy()
            assert np.abs(want).min() > 1.0
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_likelihood_draws_its_probe():
    tl = tlik.get_likelihood_fn(VPSDE(), lambda x, t: -x, rtol=1e-2,
                                atol=1e-2)
    data = torch.zeros(2, 4, 4, 3, dtype=torch.float64)
    a = tl(torch.Generator().manual_seed(0), data)[0]
    b = tl(torch.Generator().manual_seed(0), data)[0]
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError):
        tlik.get_likelihood_fn(VPSDE(), lambda x, t: x,
                               hutchinson_type="laplace")


def test_dit_label_dropout_matches_jax():
    """JAX's ``train=True`` forward drops labels where ``uniform(rng) <
    class_dropout_prob``: the port with the same mask gives the same
    output, and its own draw from a generator drops about that share."""
    from naturaldiffusion_tpu.models import dit as jdit
    from naturaldiffusion_tpu_torch.models import dit
    cfg = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
               depth=1, num_heads=2, num_classes=10, class_dropout_prob=0.5)
    jm = jdit.DiT(config=jdit.DiTConfig(**cfg))
    params = U.jax_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                          jnp.zeros((1,), jnp.int32))
    tm = load_jax_params(dit.DiT(dit.DiTConfig(**cfg), device="cpu"), params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 8, 8, 4)).astype(np.float32)
    t = np.full(6, 500.0, np.float32)
    y = np.arange(6, dtype=np.int32)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(False):
        want = np.asarray(jm.apply({"params": params}, x, t, y, train=True,
                                   rng=key))
        drop = np.asarray(jax.random.uniform(key, (6,)) < 0.5)
    assert 0 < drop.sum() < 6
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(y).long(), train=True,
                 drop=torch.from_numpy(drop)).numpy()
        kept = tm(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(y).long()).numpy()
        drawn = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    assert U.rel_l2(got, want) < 1e-5
    assert U.rel_l2(kept, want) > 1e-3
    assert abs(float((drawn < 0.5).float().mean()) - 0.5) < 0.03
