"""The pieces of the port's trainer against the JAX package's: the three
losses with their flags (JAX's draws fed to the port's "loss given the
draws"), the optimizer against optax's chain (the clip active and inactive,
the first update at learning rate 0), the EMA warm-up, and the checkpoint
protocol (a resumed run equals an uninterrupted one bit for bit, a missing
checkpoint warns, a partial write raises)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu import sde as jsde
from naturaldiffusion_tpu.train import ema as jema
from naturaldiffusion_tpu.train import losses as jl
from naturaldiffusion_tpu_torch import sde as tsde
from naturaldiffusion_tpu_torch.train import checkpoint as ckpt
from naturaldiffusion_tpu_torch.train import ema as tema
from naturaldiffusion_tpu_torch.train import losses as tl
from naturaldiffusion_tpu_torch.train.state import TrainState, make_train_step

torch.set_num_threads(2)
TOL = 1e-5
SHAPE = (3, 4, 4, 3)


def _net_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"W": (rng.standard_normal((3, 3)) * 0.5).astype(np.float32),
            "b": (rng.standard_normal(3) * 0.1).astype(np.float32)}


def jax_apply(p, x, labels):
    lab = labels.astype(jnp.float32)
    return jnp.tanh(x @ p["W"] + p["b"]) * (1.0 + 1e-3 * lab)[:, None, None,
                                                               None]


def port_apply(p, x, labels):
    lab = labels.to(torch.float32)
    return torch.tanh(x @ p["W"] + p["b"]) * (1.0 + 1e-3 * lab)[:, None,
                                                                None, None]


def _batch(seed=1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


SDES = {"vp": (jsde.VPSDE, tsde.VPSDE), "subvp": (jsde.SubVPSDE,
                                                  tsde.SubVPSDE),
        "ve": (jsde.VESDE, tsde.VESDE)}


# the VE SDE runs continuous only: its discrete case is the SMLD loss
LOSS_CASES = [(n, r, w, c) for n in sorted(SDES) for r in (True, False)
              for w in (False, True) for c in (True, False)
              if c or n != "ve"]


@pytest.mark.parametrize("name,reduce_mean,weighting,continuous", LOSS_CASES)
def test_sde_loss_matches_jax(name, reduce_mean, weighting, continuous):
    jcls, tcls = SDES[name]
    params, batch = _net_params(), _batch()
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        want = float(jl.sde_loss_fn(
            jcls(), jax_apply, jax.tree.map(jnp.asarray, params), key,
            jnp.asarray(batch), reduce_mean=reduce_mean,
            likelihood_weighting=weighting, continuous=continuous))
        kt, kz = jax.random.split(key)
        t = jax.random.uniform(kt, (SHAPE[0],), minval=1e-5, maxval=1.0)
        z = jax.random.normal(kz, SHAPE)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = float(tl.sde_loss_fn(
        tcls(), port_apply, tp, None, torch.from_numpy(batch),
        reduce_mean=reduce_mean, likelihood_weighting=weighting,
        continuous=continuous,
        draws=(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z)))))
    assert np.isfinite(want) and want != 0
    np.testing.assert_allclose(got, want, rtol=TOL)


@pytest.mark.parametrize("kind", ["smld", "ddpm"])
@pytest.mark.parametrize("reduce_mean", [True, False])
def test_discrete_losses_match_jax(kind, reduce_mean):
    params, batch = _net_params(2), _batch(3)
    key = jax.random.PRNGKey(9)
    jfn, tfn, jcls, tcls = ((jl.smld_loss_fn, tl.smld_loss_fn, jsde.VESDE,
                             tsde.VESDE) if kind == "smld" else
                            (jl.ddpm_loss_fn, tl.ddpm_loss_fn, jsde.VPSDE,
                             tsde.VPSDE))
    with jax.enable_x64(False):
        want = float(jfn(jcls(), jax_apply, jax.tree.map(jnp.asarray, params),
                         key, jnp.asarray(batch), reduce_mean=reduce_mean))
        kt, kz = jax.random.split(key)
        labels = jax.random.randint(kt, (SHAPE[0],), 0, 1000)
        z = jax.random.normal(kz, SHAPE)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = float(tfn(tcls(), port_apply, tp, None, torch.from_numpy(batch),
                    reduce_mean=reduce_mean,
                    draws=(torch.from_numpy(np.array(labels)).long(),
                           torch.from_numpy(np.array(z)))))
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_draws_from_the_generator():
    """Without draws the loss draws from its generator: the same seed, the
    same loss; t within [eps, T)."""
    params = {k: torch.from_numpy(v) for k, v in _net_params().items()}
    batch = torch.from_numpy(_batch())
    a, b = (float(tl.sde_loss_fn(tsde.VPSDE(), port_apply, params,
                                 torch.Generator().manual_seed(3), batch))
            for _ in range(2))
    assert a == b
    t, z = tl.sde_draws(tsde.VPSDE(), batch, torch.Generator().manual_seed(0))
    assert t.shape == (3,) and z.shape == SHAPE
    assert float(t.min()) >= 1e-5 and float(t.max()) < 1.0


@pytest.mark.parametrize("clip", [1e-3, 1e3, 0.0])
def test_optimizer_matches_optax(clip):
    """5 updates with warm-up 3 of the port's chain against optax's on the
    same grads: the clip active (1e-3), inactive (1e3) and off (0)."""
    rng = np.random.default_rng(11)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (5,))]
    grads = [[(rng.standard_normal(p.shape) * 0.3).astype(np.float32)
              for p in p0] for _ in range(5)]
    with jax.enable_x64(False):
        tx = jl.make_optimizer(lr=1e-2, warmup=3, grad_clip=clip)
        jp = [jnp.asarray(p) for p in p0]
        st = tx.init(jp)
        import optax
        for g in grads:
            upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
            jp = optax.apply_updates(jp, upd)
    opt = tl.make_optimizer(lr=1e-2, warmup=3, grad_clip=clip)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ost = opt.init(tp)
    first = None
    for g in grads:
        opt.update(tp, [torch.from_numpy(x) for x in g], ost)
        if first is None:
            first = [t.clone() for t in tp]
    # the schedule reads its count before incrementing: lr 0 first
    for a, b in zip(first, p0):
        np.testing.assert_array_equal(a.numpy(), b)
    assert ost.count == 5 and ost.sched_count == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert max(float(np.abs(a.numpy() - b).max()) for a, b in zip(tp, p0)) \
        > 1e-3


def test_learning_rate_schedule_matches_optax():
    import optax
    opt = tl.make_optimizer(lr=2e-4, warmup=5000)
    sched = optax.linear_schedule(0.0, 2e-4, 5000)
    with jax.enable_x64(False):
        for c in (0, 1, 2, 2500, 4999, 5000, 9000):
            assert opt.learning_rate(c) == np.float32(sched(c))


@pytest.mark.parametrize("warmup", [True, False])
def test_ema_matches_jax(warmup):
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal(6).astype(np.float32)}
    steps = [{"a": rng.standard_normal(6).astype(np.float32)}
             for _ in range(4)]
    with jax.enable_x64(False):
        e = jema.EMA.create(jax.tree.map(jnp.asarray, p0), decay=0.99,
                            warmup=warmup)
        for p in steps:
            e = e.update(jax.tree.map(jnp.asarray, p))
    te = tema.EMA.create([torch.from_numpy(p0["a"])], decay=0.99,
                         warmup=warmup)
    assert te.shadow[0] is not None and te.num_updates == 0
    for p in steps:
        te.update([torch.from_numpy(p["a"])])
    assert te.num_updates == int(e.num_updates) == 4
    np.testing.assert_allclose(te.shadow[0].numpy(), np.asarray(
        e.shadow["a"]), rtol=1e-6, atol=1e-7)


# -- checkpoints -------------------------------------------------------------


def _tiny_step():
    lin = torch.nn.Linear(3, 3)
    g = torch.Generator().manual_seed(0)
    for p in lin.parameters():
        torch.nn.init.normal_(p, generator=g)
    params = dict(lin.named_parameters())

    def apply_fn(p, x, label):
        return torch.func.functional_call(lin, p, (x,))
    init, step = make_train_step(tsde.VPSDE(), apply_fn, warmup=2)
    return init(params), step


def _run(state, step, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        batch = torch.randn(4, 2, 2, 3, generator=g)
        state, _ = step(state, g, batch)
    return state, g


def _same(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = ckpt.state_dict(a), ckpt.state_dict(b)
    for part in ("params",):
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k])
    for part in ("mu", "nu"):
        for k in sa["opt_state"][part]:
            assert torch.equal(sa["opt_state"][part][k],
                               sb["opt_state"][part][k])
    for k in sa["ema"]["shadow"]:
        assert torch.equal(sa["ema"]["shadow"][k], sb["ema"]["shadow"][k])
    assert sa["opt_state"]["count"] == sb["opt_state"]["count"]
    assert sa["ema"]["num_updates"] == sb["ema"]["num_updates"]


def test_resume_equals_uninterrupted(tmp_path):
    """3 steps, save_meta, restore into a fresh state, 3 more steps (the
    generator carried): bit for bit the 6-step run."""
    whole, step = _tiny_step()
    g = torch.Generator().manual_seed(0)
    for i in range(6):
        batch = torch.randn(4, 2, 2, 3, generator=g)
        whole, _ = step(whole, g, batch)
        if i == 2:
            gstate = g.get_state()

    first, step1 = _tiny_step()
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        first, _ = step1(first, g, torch.randn(4, 2, 2, 3, generator=g))
    ckpt.save_meta(str(tmp_path), first)
    assert os.path.isfile(tmp_path / "checkpoints-meta" / "state.pt")

    fresh, step2 = _tiny_step()
    resumed = ckpt.restore(str(tmp_path), fresh)
    assert resumed.step == 3
    g2 = torch.Generator()
    g2.set_state(gstate)
    for _ in range(3):
        resumed, _ = step2(resumed, g2, torch.randn(4, 2, 2, 3, generator=g2))
    _same(resumed, whole)


def test_snapshots_and_restore_by_path(tmp_path):
    state, step = _tiny_step()
    state, _ = _run(state, step, 2)
    path = ckpt.save_snapshot(str(tmp_path), state, 2)
    state, _ = _run(state, step, 1, seed=1)
    ckpt.save_snapshot(str(tmp_path), state, 3)
    assert ckpt.latest_snapshot_step(str(tmp_path)) == 3
    fresh, _ = _tiny_step()
    got = ckpt.restore(path, fresh)
    assert got.step == 2 and got.opt_state.count == 2


def test_missing_checkpoint_warns(tmp_path, caplog):
    state, _ = _tiny_step()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    os.makedirs(tmp_path / "empty")
    for where in (tmp_path / "nothing", tmp_path / "empty"):
        with caplog.at_level(logging.WARNING):
            got = ckpt.restore(str(where), state)
        assert got is state and "No checkpoint found" in caplog.text
    assert all(torch.equal(before[k], v) for k, v in state.params.items())
    assert ckpt.latest_snapshot_step(str(tmp_path)) is None


def test_partial_write_raises(tmp_path):
    state, _ = _tiny_step()
    ckpt.save_meta(str(tmp_path), state)
    os.remove(tmp_path / "checkpoints-meta" / "state.pt")
    with pytest.raises(FileNotFoundError, match="partial write"):
        ckpt.restore(str(tmp_path), state)


def test_restore_refuses_another_model(tmp_path):
    state, _ = _tiny_step()
    ckpt.save_meta(str(tmp_path), state)
    lin = torch.nn.Linear(3, 4)
    init, _ = make_train_step(tsde.VPSDE(), lambda p, x, t: x)
    with pytest.raises(KeyError, match="differ"):
        ckpt.restore(str(tmp_path), init(dict(lin.named_parameters())))
    got = ckpt.load_state_dict(os.path.join(tmp_path, "checkpoints-meta"))
    assert set(got["params"]) == {"weight", "bias"} and got["step"] == 0
