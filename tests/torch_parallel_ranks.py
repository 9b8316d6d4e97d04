"""The rank side of ``tests/test_torch_parallel.py``: every multi-rank
computation of that file, run on each of 4 spawned gloo ranks
(``parallel.dryrun.spawn_gloo``).  It imports the port and numpy only (no
JAX): the parent computes the JAX oracles and holds rank 0's results,
which land in ``<workdir>/results.npy``, against them."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from naturaldiffusion_tpu_torch.ops import attention as A
from naturaldiffusion_tpu_torch.parallel import (dit_tp_sharding,
                                                 fsdp_sharding, make_mesh,
                                                 mmdit_tp_sharding, named,
                                                 shard_batch)
from naturaldiffusion_tpu_torch.parallel.shardings import (apply_shardings,
                                                           full)

# the DiT of the multi-chip dry run (JAX __graft_entry__.py:111-113)
DIT = dict(input_size=8, patch_size=2, in_channels=3, hidden_size=64,
           depth=2, num_heads=4, num_classes=10, learn_sigma=False,
           class_dropout_prob=0.0)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "send", "recv", "isend",
               "irecv", "batch_isend_irecv", "all_to_all_single", "scatter",
               "reduce", "gather")


def _randn(*shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _perturbed(module, scale, seed):
    with torch.no_grad():
        for i, p in enumerate(module.parameters()):
            p.add_(scale * _randn(*p.shape, seed=seed * 1000 + i))
    return module


RING_CASES = (("t48_ring4", {"model": 4}, 48),
              ("t64_ring2", {"data": 2, "model": 2}, 64))


def ring_inputs(t):
    """q, k, v and the output's cotangent of a ring case."""
    return tuple(_randn(2, 3, t, 16, seed=s) for s in (1, 2, 3, 4))


def _grads(fn, ins, cot):
    leaves = [a.detach().clone().requires_grad_() for a in ins]
    out = fn(*leaves)
    return out, torch.autograd.grad((out * cot).sum(), leaves)


def ring_checks(out):
    """Ring attention against full attention: T 48 over a 4-rank ring and
    T 64 over the 2-rank model axis of a (data 2, model 2) mesh; its
    gradients, for plain and for T-sharded DTensor inputs, against
    autograd through the plain attention (the parent holds rank 0's
    against ``jax.grad`` of JAX's ring)."""
    from naturaldiffusion_tpu_torch.ops.ring_attention import ring_mha
    for name, axes, t in RING_CASES:
        mesh = make_mesh(axes, device="cpu")
        q, k, v, cot = ring_inputs(t)
        want = A.mha_reference(q, k, v, 0.25)
        spec = named(mesh, None, None, "model", None)
        got = ring_mha(*(spec.distribute(a) for a in (q, k, v)), mesh,
                       sm_scale=0.25)
        i = mesh.mesh_dim_names.index("model")
        out[f"ring_{name}_placement_is_t_shard"] = (
            isinstance(got, DTensor) and got.placements[i] == Shard(2)
            and got.to_local().shape[2] == t // mesh.size(i))
        out[f"ring_{name}_err"] = float((got.full_tensor() - want).abs()
                                        .max())
        _, want_g = _grads(lambda a, b, c: A.mha_reference(a, b, c, 0.25),
                           (q, k, v), cot)
        plain, got_g = _grads(lambda a, b, c: ring_mha(a, b, c, mesh,
                                                       sm_scale=0.25),
                              (q, k, v), cot)
        out[f"ring_{name}_plain_err"] = float((plain - want).abs().max())
        out[f"ring_{name}_grads"] = [g.numpy() for g in got_g]
        out[f"ring_{name}_grad_err"] = max(
            float((g - w).abs().max()) for g, w in zip(got_g, want_g))
        leaves = [spec.distribute(a).requires_grad_() for a in (q, k, v)]
        dt_out = ring_mha(*leaves, mesh, sm_scale=0.25)
        dt_g = torch.autograd.grad((dt_out.full_tensor() * cot).sum(),
                                   leaves)
        out[f"ring_{name}_dtensor_grad_placements"] = all(
            isinstance(g, DTensor) and g.placements == a.placements
            for g, a in zip(dt_g, leaves))
        out[f"ring_{name}_dtensor_grad_err"] = max(
            float((g.full_tensor() - w).abs().max())
            for g, w in zip(dt_g, want_g))


def _ring_dit_pair():
    """The replicated DiT (plain attention) and the ring DiT on its
    weights over a (data 2, model 2) mesh."""
    from naturaldiffusion_tpu_torch.models.dit import DiT, DiTConfig
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    cfg = DiTConfig(**dict(DIT, patch_size=1, hidden_size=32))
    ref = _perturbed(DiT(cfg, device="cpu", seed=12, attn_backend="xla"),
                     0.05, 5)
    ring = DiT(cfg, device="cpu", seed=12, attn_backend="ring", mesh=mesh)
    ring.load_state_dict(ref.state_dict())
    return ref, ring


def ring_dit(out):
    ref, ring = _ring_dit_pair()
    x = _randn(4, 8, 8, 3, seed=11)
    t, y = torch.linspace(0.0, 999.0, 4), torch.arange(4) % 10
    with torch.no_grad():
        out["ring_dit_err"] = float((ring(x, t, y) - ref(x, t, y)).abs()
                                    .max())


def ring_dit_train(out):
    """Two train steps of the ring DiT on replicated parameters and a
    plain batch (the same on every rank) against the replicated DiT's."""
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train import make_train_step
    batch = _randn(4, 8, 8, 3, seed=22)
    runs = []
    for m in _ring_dit_pair():
        init, step = make_train_step(VPSDE(), _dit_apply(m), warmup=10)
        st = init({k: v.detach().clone().requires_grad_()
                   for k, v in m.named_parameters()})
        losses = []
        for s in (5, 6):
            st, loss = step(st, torch.Generator().manual_seed(s), batch)
            losses.append(float(loss))
        runs.append((st, losses))
    (rs, rl), (gs, gl) = runs
    out["ring_train_loss"], out["ring_train_rep_loss"] = gl, rl
    out["ring_train_state_err"] = _state_err(gs, rs)


def mmdit_tp(out, workdir):
    """The MMDiT on the parent's numpy weights under TP + SP, its forward on
    a batch-sharded input (the parent holds it against JAX's replicated
    forward)."""
    from naturaldiffusion_tpu_torch.models import mmdit as tm
    from naturaldiffusion_tpu_torch.models.convert import load_jax_params
    blob = np.load(os.path.join(workdir, "mmdit.npy"),
                   allow_pickle=True).item()
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    model = load_jax_params(tm.MMDiT(tm.MMDiTConfig(**blob["cfg"]),
                                     device="cpu",
                                     token_constraint=named(
                                         mesh, "data", "model", None)),
                            blob["params"])
    apply_shardings(model, mmdit_tp_sharding(model, mesh))
    x, t, ctx, pooled = (torch.from_numpy(a) for a in blob["inputs"])
    with torch.no_grad():
        got = model(shard_batch(mesh, x), t, ctx, pooled)
    out["mmdit_batch_sharded"] = got.placements[0] == Shard(0)
    out["mmdit_tp_forward"] = got.full_tensor().numpy()
    q = model.transformer_blocks_0.attn_to_q.kernel
    out["mmdit_q_local_shape"] = tuple(q.to_local().shape)


def _dit_apply(model):
    def apply_fn(p, x, t_label):
        y = torch.zeros(x.shape[0], dtype=torch.long)
        return torch.func.functional_call(model, p, (x, t_label, y))
    return apply_fn


def _leaves(st):
    return (list(st.params.values()), st.opt_state.mu, st.opt_state.nu,
            st.ema.shadow)


def _max_diff(a, b):
    return max(float((full(x) - full(y)).abs().max()) for x, y in zip(a, b))


def _state_err(st, ref):
    """Relative L2 of Adam's moments (the record of the two steps'
    gradients), all leaves as one vector.  The parameters themselves say
    little: an Adam step moves each by about the learning rate whatever the
    gradient, and where a gradient is near zero its sign flips with the
    order of the sums."""
    num = den = 0.0
    for a, b in zip(_leaves(st)[1:3], _leaves(ref)[1:3]):
        for x, y in zip(a, b):
            x, y = full(x).double(), full(y).double()
            num += float((x - y).norm()) ** 2
            den += float(y.norm()) ** 2
    return math.sqrt(num / den)


def train_steps(out):
    """The DiT TP + SP train step (2 steps) against the replicated one, and
    FSDP over a 4-rank data axis against its replicated DP step, with the
    state's local bytes."""
    from naturaldiffusion_tpu_torch.models.dit import DiT, DiTConfig
    from naturaldiffusion_tpu_torch.sde import VPSDE
    from naturaldiffusion_tpu_torch.train import make_train_step
    cfg = DiTConfig(**DIT)
    batch = _randn(8, 8, 8, 3, seed=21)

    def model(tc=None):
        return _perturbed(DiT(cfg, device="cpu", seed=0, token_constraint=tc),
                          0.02, 1)

    def run(m, state_of, batch_of, mesh=None):
        init, step = make_train_step(VPSDE(), _dit_apply(m), warmup=10,
                                     mesh=mesh)
        st = state_of(init, m)
        losses = []
        for s in (3, 4):
            st, loss = step(st, torch.Generator().manual_seed(s),
                            batch_of(batch))
            losses.append(float(loss))
        return st, losses

    def plain_state(init, m):
        return init({k: v.detach().clone().requires_grad_()
                     for k, v in m.named_parameters()})
    rs, rl = run(model(), plain_state, lambda b: b)

    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    tm = model(named(mesh, "data", "model", None))
    apply_shardings(tm, dit_tp_sharding(tm, mesh))
    ts, tl = run(tm, lambda init, m: init(dict(m.named_parameters())),
                 lambda b: shard_batch(mesh, b))
    out["tp_loss"], out["rep_loss"] = tl, rl
    out["tp_state_err"] = _state_err(ts, rs)
    out["tp_qkv_local_shape"] = tuple(
        tm.blocks_0.attn.qkv.kernel.to_local().shape)

    m4 = make_mesh({"data": 4}, device="cpu")
    ds, dl = run(model(), plain_state, lambda b: b, m4)

    def fsdp_state(init, m):
        st = plain_state(init, m)
        return apply_shardings(st, fsdp_sharding(st, m4, min_size=2 ** 8))
    fs, fl = run(model(), fsdp_state, lambda b: b, m4)
    out["dp_loss"], out["fsdp_loss"] = dl, fl
    out["dp_state_err"] = _state_err(ds, rs)
    out["fsdp_state_err"] = _state_err(fs, rs)
    out["fsdp_vs_dp_err"] = max(_max_diff(a, b) for a, b in zip(
        _leaves(fs), _leaves(ds)))

    def nbytes(st, local):
        return sum((t.to_local() if local and isinstance(t, DTensor)
                    else full(t)).numel() * 4
                   for leaves in _leaves(st) for t in leaves)
    out["fsdp_bytes_full"] = nbytes(fs, False)
    out["fsdp_bytes_local"] = nbytes(fs, True)


class CollectiveCount:
    """Counts the ``torch.distributed`` collectives and point-to-point
    calls (and DTensor's functional collectives) made inside the block."""

    def __init__(self):
        import torch.distributed._functional_collectives as fc
        self.mods = [(dist, COLLECTIVES), (fc, tuple(
            n for n in dir(fc) if n.startswith(("all_", "reduce_",
                                                "broadcast", "permute"))))]
        self.calls = []

    def __enter__(self):
        self.saved = []
        for mod, names in self.mods:
            for n in names:
                fn = getattr(mod, n, None)
                if callable(fn):
                    self.saved.append((mod, n, fn))
                    setattr(mod, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def dp_sampling(out):
    """DP Natural Inference (``cifar10_ni.make_sampler(mesh=)``, device-
    aligned chunks) against the replicated run on the same global noises,
    with the collectives counted inside; DP FID activations against the
    single-rank ones."""
    from naturaldiffusion_tpu_torch.apps.cifar10_ni import make_sampler
    from naturaldiffusion_tpu_torch.apps.roundtrip import toy_feature_fn
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.eval.fid import activations
    from naturaldiffusion_tpu_torch.models.ncsnpp import (NCSNpp,
                                                          NCSNppConfig)
    mesh = make_mesh({"data": 4}, device="cpu")
    net = _perturbed(NCSNpp(NCSNppConfig(
        image_size=8, nf=16, ch_mult=(1, 2), num_res_blocks=1,
        attn_resolutions=(4,)), device="cpu", seed=7), 0.02, 3)
    matrix = registry.derive("ddpm", 3)
    init = _randn(16, 8, 8, 3, seed=31)
    noises = _randn(3, 16, 8, 8, 3, seed=32)
    rep = make_sampler(net, matrix, micro=8, dtype=torch.float32,
                       device="cpu")(init, noises=noises)
    run = make_sampler(net, matrix, micro=8, dtype=torch.float32,
                       device="cpu", mesh=mesh)
    sharded = shard_batch(mesh, init)
    with CollectiveCount() as cc:
        got = run(sharded, noises=noises)
    out["dp_ni_collectives"] = list(cc.calls)
    out["dp_ni_local_rows"] = got.to_local().shape[0]
    out["dp_ni_err"] = float((got.full_tensor() - rep).abs().max())
    # a global plain batch: each rank takes its rows
    out["dp_ni_plain_err"] = float(
        (run(init, noises=noises).full_tensor() - rep).abs().max())

    fn = toy_feature_fn(64, device="cpu")
    images = torch.rand(30, 8, 8, 3, generator=torch.Generator()
                        .manual_seed(33))
    one = activations(images, fn, batch_size=8, pad_to_batch=True)
    many = activations(images, fn, batch_size=8, mesh=mesh,
                       pad_to_batch=True)
    out["dp_activations_err"] = float(np.abs(many - one).max())
    out["dp_activations_shape"] = many.shape


def run(rank, n, workdir):
    out = {}
    ring_checks(out)
    ring_dit(out)
    ring_dit_train(out)
    mmdit_tp(out, workdir)
    train_steps(out)
    dp_sampling(out)
    if rank == 0:
        np.save(os.path.join(workdir, "results.npy"), out, allow_pickle=True)
    dist.barrier()
