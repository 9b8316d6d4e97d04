"""The multi-rank dry run (port of the JAX package's
``__graft_entry__.py:dryrun_multichip``): one sharded training step and the
parallel inference paths on an n-rank mesh, each held against its
replicated run, in JAX's order:

1. the DiT TP+SP train step (DTensor parameters by ``dit_tp_sharding``, the
   batch sharded over ``data``, tokens over ``model`` between blocks), two
   steps in f32 and one in bf16 mixed precision beside the f32 one;
2. FSDP (the state sharded over ``data``) against the replicated step;
3. the MMDiT TP+SP forward against the replicated forward;
4. data-parallel Natural Inference, plain (DiT) and schedule-hoisted
   (NCSN++), against the replicated run;
5. the data-parallel fused-resblock conv path against the unfused forward;
6. the data-parallel int8 conv path close to float;
7. the ring-attention DiT forward against the replicated forward.

``dryrun_multichip()`` runs on the card, as every entry point does, in
this process on a 1-rank NCCL mesh (NCCL takes one rank a card), where
every collective is a no-op and the checks exercise the wiring and the
kernels; without a card it raises.  ``dryrun_multichip(n, device="cpu")``
spawns ``n`` gloo ranks on the host (:func:`spawn_gloo`) for the
multi-rank arithmetic.

    python -m naturaldiffusion_tpu_torch.parallel.dryrun
    python -m naturaldiffusion_tpu_torch.parallel.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def spawn_gloo(fn, n: int, workdir: str, *args) -> None:
    """Run ``fn(rank, n, workdir, *args)`` on ``n`` spawned CPU ranks, each
    in a gloo group over a ``FileStore`` in ``workdir`` with one thread;
    raises if a rank fails.  ``fn`` must be importable by name (a module
    function)."""
    import torch.multiprocessing as mp
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank_main, args=(n, store, fn, workdir, args), nprocs=n,
             join=True)


def _rank_main(rank, n, store, fn, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(rank, n, workdir, *args)
    finally:
        dist.destroy_process_group()


def _check(ok, what) -> None:
    """A dry-run check (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _max_err(got, want) -> float:
    from .shardings import full
    return float((full(got).float() - full(want).float()).abs().max())


def _seeded_(module, scale: float, seed: int):
    """Perturb every parameter by ``scale`` times a seeded normal draw (the
    JAX init zeroes the adaLN and output layers)."""
    with torch.no_grad():
        for i, p in enumerate(module.parameters()):
            g = torch.Generator().manual_seed(seed * 1000 + i)
            p.add_(scale * torch.randn(p.shape, generator=g).to(p.device))
    return module


def _mesh_axes(n: int) -> dict:
    if n % 2 == 0 and n > 1:
        return {"data": n // 2, "model": 2}
    return {"data": n, "model": 1}


def dryrun_body(n: int, device="cpu", log=print) -> dict:
    """The checks on this rank (see the module docstring); returns the
    measured errors.  Every rank of the process group runs it."""
    from ..coeffs import registry
    from ..coeffs.sd3 import sd3_euler_weights, sd3_weight_matrix
    from ..engine import NISchedule, natural_inference
    from ..models.dit import DiT, DiTConfig
    from ..models.mmdit import MMDiT, MMDiTConfig
    from ..models.ncsnpp import (NCSNpp, NCSNppConfig,
                                 ncsnpp_schedule_biases)
    from ..sde import VPSDE
    from ..train import make_train_step
    from . import (dit_tp_sharding, fsdp_sharding, make_mesh,
                   mmdit_tp_sharding, named, shard_batch)
    from .mesh import local_rows
    from .shardings import apply_shardings, full

    dev = resolve_device(device)
    mesh = make_mesh(_mesh_axes(n), device=dev)
    out = {}
    tok_ns = named(mesh, "data", "model", None)            # Megatron SP
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=3,
                    hidden_size=64, depth=2, num_heads=4, num_classes=10,
                    learn_sigma=False, class_dropout_prob=0.0)
    b = max(2 * n, 4)

    def dit(token_constraint=None, **kw):
        return _seeded_(DiT(cfg, device=dev, seed=0,
                            token_constraint=token_constraint, **kw),
                        0.02, 1)

    def apply_of(model):
        def apply_fn(p, xx, t_label):         # a fixed null label
            yy = torch.zeros(xx.shape[0], dtype=torch.long, device=dev)
            return torch.func.functional_call(model, p, (xx, t_label, yy))
        return apply_fn

    batch = torch.zeros((b, 8, 8, 3), device=dev) + 0.1
    batch = batch + 0.05 * torch.randn(
        batch.shape, generator=torch.Generator().manual_seed(4)).to(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # 1. DiT TP+SP train step: two f32 steps, then bf16 beside f32
    model = dit(tok_ns)
    apply_shardings(model, dit_tp_sharding(model, mesh))
    init_fn, step_fn = make_train_step(VPSDE(), apply_of(model), warmup=10)
    state = init_fn(dict(model.named_parameters()))
    sbatch = shard_batch(mesh, batch)
    for seed in (1, 2):
        state, loss = step_fn(state, gen(seed), sbatch)
        _check(bool(torch.isfinite(loss)), f"TP+SP step loss {loss}")
    _, bf16_step = make_train_step(VPSDE(), apply_of(model), warmup=10,
                                   compute_dtype=torch.bfloat16)
    _, floss = step_fn(copy.deepcopy(state), gen(9), sbatch)
    bst, bloss = bf16_step(copy.deepcopy(state), gen(9), sbatch)
    _check(bool(torch.isfinite(bloss)), f"bf16 step loss {bloss}")
    _check(all(p.dtype == torch.float32 for p in bst.params.values()),
           "the bf16 step's master parameters are not float32")
    _check(abs(float(bloss) - float(floss)) < 0.05 * abs(float(floss))
           + 1e-3, f"bf16 loss {float(bloss)} vs f32 {float(floss)}")
    out["tp_sp_loss"] = float(loss)
    out["bf16_loss"], out["f32_loss"] = float(bloss), float(floss)
    log(f"dryrun: DiT TP+SP train step ok; bf16 mixed-precision loss "
        f"{float(bloss):.4f} vs f32 {float(floss):.4f}")

    # 2. FSDP (ZeRO-3) against the replicated step
    rmodel = dit()
    init_dp, step_dp = make_train_step(VPSDE(), apply_of(rmodel), warmup=10,
                                       mesh=mesh)

    def fresh():
        return init_dp({k: v.detach().clone().requires_grad_()
                        for k, v in rmodel.named_parameters()})
    rs, rloss = step_dp(fresh(), gen(3), batch)
    fs = fresh()
    fs = apply_shardings(fs, fsdp_sharding(fs, mesh, min_size=2 ** 8))
    fs, fsloss = step_dp(fs, gen(3), batch)
    err = max(_max_err(a, c) for a, c in zip(fs.params.values(),
                                             rs.params.values()))
    _check(abs(float(fsloss) - float(rloss)) < 1e-5 and err < 1e-5,
           f"FSDP loss {float(fsloss)} vs {float(rloss)}, params {err}")
    out["fsdp_err"] = err
    log(f"dryrun: FSDP (ZeRO-3) train step == replicated (err {err:.2e})")

    # 3. MMDiT TP+SP forward against the replicated forward
    mcfg = MMDiTConfig(sample_size=8, patch_size=2, in_channels=4,
                       hidden_size=64, depth=2, num_heads=4,
                       caption_projection_dim=64, joint_attention_dim=32,
                       pooled_projection_dim=48, pos_embed_max_size=8)
    mm_rep = _seeded_(MMDiT(mcfg, device=dev, seed=3), 0.05, 2)
    mm_tp = MMDiT(mcfg, device=dev, seed=3, token_constraint=tok_ns)
    mm_tp.load_state_dict(mm_rep.state_dict())
    apply_shardings(mm_tp, mmdit_tp_sharding(mm_tp, mesh))
    xs = torch.ones((b, 8, 8, 4), device=dev) * 0.1
    ts = torch.linspace(0.1, 0.9, b, device=dev)
    ctx = torch.ones((b, 6, 32), device=dev) * 0.05
    pooled = torch.ones((b, 48), device=dev) * 0.05
    with torch.no_grad():
        want = mm_rep(xs, ts, ctx, pooled)
        got = mm_tp(shard_batch(mesh, xs), ts, ctx, pooled)
    err = _max_err(got, want)
    _check(err < 2e-5, f"MMDiT TP/SP != replicated (max err {err})")
    out["mmdit_err"] = err

    # 4. DP Natural Inference: plain (the DiT) and schedule-hoisted (an
    # NCSN++), each rank on its rows, against the replicated trajectory
    def dp(fn, z, *rest):
        """``fn`` on this rank's rows of the global ``z`` (and of each
        global ``rest`` tensor along dim 1, the noises' batch dim),
        gathered."""
        from torch.distributed.tensor import DTensor
        from .mesh import axis_index, axis_size, batch_sharding
        loc = local_rows(z, mesh)
        nd, i = axis_size(mesh, "data"), axis_index(mesh, "data")
        rest = [r.chunk(nd, dim=1)[i] for r in rest]
        y = fn(loc, *rest)
        return DTensor.from_local(y, mesh, batch_sharding(
            mesh, y.dim()).placements, run_check=False).full_tensor()

    sched = NISchedule.from_matrix(registry.derive("ddpm", 6), device=dev)
    z = torch.randn((b, 8, 8, 3), generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    noises = torch.randn((sched.num_step, b, 8, 8, 3),
                         generator=torch.Generator().manual_seed(6)).to(dev)
    rep = dit()

    def eps_fn(zz, t):
        yy = torch.zeros(zz.shape[0], dtype=torch.long, device=dev)
        return rep(zz, t.reshape(1).expand(zz.shape[0]), yy)

    def ni(zz, nz):
        return natural_inference(eps_fn, sched, zz, noises=nz,
                                 prediction_type="eps")
    with torch.no_grad():
        err = _max_err(dp(ni, z, noises), ni(z, noises))
    _check(err < 2e-5, f"DP NI != replicated trajectory (max err {err})")
    out["dp_ni_err"] = err

    ucfg = NCSNppConfig(image_size=8, num_channels=3, nf=16, ch_mult=(1, 2),
                        num_res_blocks=1, attn_resolutions=(4,))
    unet = _seeded_(NCSNpp(ucfg, device=dev, seed=7), 0.02, 3)
    mods = ncsnpp_schedule_biases(unet, sched.node[:sched.num_step, 0])

    def ni_hoisted(zz, nz):
        return natural_inference(
            lambda x, t, aux: unet(x, t.reshape(1).expand(x.shape[0]),
                                   mods=aux),
            sched, zz, noises=nz, prediction_type="eps", step_inputs=mods)
    with torch.no_grad():
        err = _max_err(dp(ni_hoisted, z, noises), ni_hoisted(z, noises))
    _check(err < 2e-5, f"DP hoisted NI != replicated (max err {err})")
    out["dp_hoisted_err"] = err

    # SD3-form NI (the sigma-reprojection schedule) through the TP+SP
    # MMDiT on DP-sharded latents against the replicated model
    msched = NISchedule.from_matrix(
        sd3_weight_matrix(sd3_euler_weights(4, shift=3.0), 4, shift=3.0),
        device=dev)

    def v_fn_of(mm, shard):
        def v_fn(zz, t):
            x_in = shard_batch(mesh, zz) if shard else zz
            return full(mm(x_in, t.reshape(1).expand(zz.shape[0]), ctx,
                           pooled))
        return v_fn
    with torch.no_grad():
        want_mm = natural_inference(v_fn_of(mm_rep, False), msched, xs,
                                    prediction_type="v_flow")
        got_mm = natural_inference(v_fn_of(mm_tp, True), msched, xs,
                                   prediction_type="v_flow")
    err = _max_err(got_mm, want_mm)
    _check(err < 2e-5, f"TP+SP MMDiT NI != replicated (max err {err})")
    out["mmdit_ni_err"] = err
    log("dryrun: DP NI parity (plain + schedule-hoisted) + TP+SP MMDiT NI "
        "ok")

    # 5. the fused-resblock conv path (NATDIFF_PALLAS_CONV=2) on each
    # rank's rows against the replicated unfused forward (switch 0), f32
    # convolutions without TF32
    ccfg = NCSNppConfig(image_size=8, num_channels=3, nf=128, ch_mult=(1,),
                        num_res_blocks=1, attn_resolutions=())
    # perturbed: the init's zero convs would leave the fused path unread
    cmodel = _seeded_(NCSNpp(ccfg, device=dev, seed=8), 0.02, 4)
    qmodel = NCSNpp(ccfg, device=dev, seed=8).to(torch.bfloat16)

    def conv_fwd(zz, m=cmodel):
        return m(zz, torch.full((zz.shape[0],), 500.0, device=dev))

    saved = {k: os.environ.get(k) for k in ("NATDIFF_PALLAS_CONV",
                                            "NATDIFF_QUANT")}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        os.environ.pop("NATDIFF_QUANT", None)
        with torch.no_grad():
            os.environ["NATDIFF_PALLAS_CONV"] = "0"
            want_c = conv_fwd(z)
            os.environ["NATDIFF_PALLAS_CONV"] = "2"
            got_c = dp(conv_fwd, z)
            err = _max_err(got_c, want_c)
            _check(err < 5e-5, f"DP fused-conv forward != unfused ({err})")
            out["dp_fused_conv_err"] = err
            log(f"dryrun: fused-resblock conv path DP-sharded ok "
                f"(err {err:.2e})")

            # 6. W8A8 int8 convs on each rank's rows, close to the float
            # forward (JAX's init); both in bf16 activations, the type the
            # card's int8 kernel takes
            def bf16_fwd(zz):
                return conv_fwd(zz.to(torch.bfloat16), qmodel).float()
            os.environ["NATDIFF_PALLAS_CONV"] = "0"
            want_q = bf16_fwd(z)
            os.environ["NATDIFF_QUANT"] = "int8"
            got_q = dp(bf16_fwd, z)
            qerr = _max_err(got_q, want_q)
            rel = qerr / (float(want_q.abs().max()) + 1e-12)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _check(bool(torch.isfinite(got_q).all()) and rel < 5e-2,
           f"DP int8 forward off float by {qerr} (rel {rel})")
    out["dp_int8_rel"] = rel
    log(f"dryrun: DP-sharded int8 conv forward ~= float (rel {rel:.2e})")

    # 7. ring attention: a ring-backend DiT forward against the replicated
    # one (its plain einsum attention: head dim 8 is no kernel's)
    rcfg = DiTConfig(input_size=8, patch_size=1, in_channels=3,
                     hidden_size=32, depth=2, num_heads=4, num_classes=10,
                     learn_sigma=False, class_dropout_prob=0.0)
    rref = _seeded_(DiT(rcfg, device=dev, seed=12, attn_backend="xla"),
                    0.05, 5)
    rring = DiT(rcfg, device=dev, seed=12, attn_backend="ring", mesh=mesh)
    rring.load_state_dict(rref.state_dict())
    xr = torch.randn((4, 8, 8, 3), generator=torch.Generator().manual_seed(
        11)).to(dev)
    tr = torch.linspace(0.0, 999.0, 4, device=dev)
    yr = torch.arange(4, device=dev) % 10
    with torch.no_grad():
        err = _max_err(rring(xr, tr, yr), rref(xr, tr, yr))
    _check(err < 2e-5, f"ring-attention DiT != replicated (max err {err})")
    out["ring_err"] = err
    log(f"dryrun: ring-attention DiT forward == replicated (err {err:.2e})")
    return out


def _spawned(rank, n, workdir, device):
    res = dryrun_body(n, device, log=print if rank == 0 else
                      (lambda *a: None))
    if rank == 0:
        np.save(os.path.join(workdir, "result.npy"), res, allow_pickle=True)


def dryrun_multichip(n: int = 1, device="cuda") -> dict:
    """The dry run on ``n`` ranks (see the module docstring); returns rank
    0's errors.  ``device="cuda"`` (the default): this process, 1 rank
    (``n`` must be 1), raising without a card; ``"cpu"``: ``n`` spawned
    gloo ranks."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        if n != 1:
            raise ValueError("on the card the dry run is 1 rank (NCCL takes "
                             "one rank a card); the multi-rank arithmetic "
                             "runs on the CPU")
        return dryrun_body(1, dev)
    with tempfile.TemporaryDirectory() as d:
        spawn_gloo(_spawned, n, d, "cpu")
        return np.load(os.path.join(d, "result.npy"),
                       allow_pickle=True).item()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=1,
                   help="ranks: 1 on the card; more with --device cpu")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip ok on {args.n} rank(s): {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
