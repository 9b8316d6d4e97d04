"""Score-SDE training and evaluation driver (port of
``naturaldiffusion_tpu/apps/train.py``: the reference's
``deps/score_sde_pytorch/{main,run_lib}.py`` as one CLI).

    python -m naturaldiffusion_tpu_torch.apps.train --workdir /tmp/run \\
        --mode train --sde vpsde --data-dir <cifar-10-batches-bin> \\
        --n-iters 1000

One train step (DSM loss, Adam with warm-up and clip, EMA; the kernels'
Functions in the model), two-tier checkpoints (preemption ``checkpoints-
meta`` and numbered snapshots), EMA sampling snapshots through the PC
sampler: the reference's ``train()`` loop (``run_lib.py:47-173``).  Runs on
the card unless ``--device cpu``.

Departures from the JAX driver, each because the port holds one card:
``--fsdp`` raises until the parallelism slice; ``--donate`` has nothing
left to do (the step updates the state in place).  Two more keep a resumed
run equal to an uninterrupted one: the draws of step ``i`` come from a
generator seeded by ``(seed, i)``, as JAX folds ``i`` into its key, and a
resumed run skips the ``start`` batches the data stream had yielded (JAX's
driver starts its iterator afresh).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..data import get_dataset, get_inverse_scaler
from ..device import resolve_device
from ..models.ncsnpp import NCSNpp, NCSNppConfig
from ..sde import VESDE, SubVPSDE, VPSDE, get_score_fn
from ..samplers.pc import get_pc_sampler
from ..train import checkpoint as ckpt
from ..train import make_train_step
from ..train.state import functional_apply
from ..utils.metrics import MetricsWriter
from ..utils.plotting import save_image_grid

_SDES = {"vpsde": (VPSDE, dict(predictor="euler_maruyama",
                               corrector="none")),
         "subvpsde": (SubVPSDE, dict(predictor="euler_maruyama",
                                     corrector="none")),
         "vesde": (VESDE, dict(predictor="reverse_diffusion",
                               corrector="langevin"))}


@dataclasses.dataclass
class TrainConfig:
    workdir: str = "workdir"
    sde: str = "vpsde"
    dataset: str = "cifar10"
    data_dir: str | None = None
    batch: int = 128
    n_iters: int = 1_300_001          # reference default
    lr: float = 2e-4
    warmup: int = 5000
    grad_clip: float = 1.0
    ema_decay: float = 0.9999
    log_freq: int = 50
    snapshot_freq: int = 50_000
    preemption_freq: int = 10_000     # snapshot_freq_for_preemption
    sample_at_snapshot: bool = True
    sample_steps: int | None = None   # the snapshot sampler's N (the SDE's)
    bpd: bool = False
    nf: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 4
    bf16: bool = False                # mixed precision (f32 master state)
    seed: int = 42
    donate: bool = False
    fsdp: bool = False
    device: str = "cuda"


def build_model(cfg: TrainConfig, dev) -> NCSNpp:
    return NCSNpp(NCSNppConfig(nf=cfg.nf, ch_mult=tuple(cfg.ch_mult),
                               num_res_blocks=cfg.num_res_blocks),
                  device=dev, seed=cfg.seed)


def step_generator(dev, seed: int, i: int) -> torch.Generator:
    """The draws of step ``i``: a generator seeded by ``(seed, i)``."""
    return torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)


def setup(cfg: TrainConfig):
    """(model, step_fn, state restored from the workdir if it holds one)."""
    if cfg.fsdp:
        raise NotImplementedError(
            "--fsdp shards the state over a mesh: it comes with the "
            "parallelism slice (ROADMAP.md, Queue A, entry 12)")
    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        # f32 is the reference's precision: no TF32 in the f32 products
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    sde = _SDES[cfg.sde][0]()
    model = build_model(cfg, dev)
    init_fn, step_fn = make_train_step(
        sde, functional_apply(model), lr=cfg.lr, warmup=cfg.warmup,
        grad_clip=cfg.grad_clip,
        compute_dtype=torch.bfloat16 if cfg.bf16 else None)
    state = init_fn(dict(model.named_parameters()))
    state.ema.decay = cfg.ema_decay
    state = ckpt.restore(cfg.workdir, state)     # preemption resume
    return sde, model, step_fn, state, dev


def train(cfg: TrainConfig):
    """The training loop; returns the final state."""
    sde, model, step_fn, state, dev = setup(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    start = state.step
    print(f"model: {n_params / 1e6:.1f}M params, device: {dev}, start step "
          f"{start}")
    it = get_dataset(cfg.dataset, cfg.batch, data_dir=cfg.data_dir)
    for _ in range(start):                       # the stream resumes
        next(it)
    metrics = MetricsWriter(cfg.workdir)

    t0, last = time.time(), start
    for i in range(start, cfg.n_iters):
        images, _ = next(it)
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        state, loss = step_fn(state, step_generator(dev, cfg.seed + 1, i),
                              batch)
        if i % cfg.log_freq == 0:
            loss = float(loss)
            rate = (i - last) * cfg.batch / max(time.time() - t0, 1e-9)
            print(f"step {i:>8d} loss {loss:.5f} ({rate:.0f} img/s)")
            metrics.scalar("training_loss", loss, i)
            metrics.scalar("img_per_sec", rate, i)
            t0, last = time.time(), i
        if i and i % cfg.preemption_freq == 0:
            ckpt.save_meta(cfg.workdir, state)
        if i and i % cfg.snapshot_freq == 0:
            path = ckpt.save_snapshot(cfg.workdir, state, i)
            print(f"snapshot -> {path}")
            if cfg.sample_at_snapshot:
                sample_snapshot(cfg, sde, model, state, i, dev)
    ckpt.save_meta(cfg.workdir, state)
    metrics.close()
    return state


def ema_params(model, state) -> dict:
    """The EMA shadow under the model's parameter names."""
    return dict(zip(state.params, state.ema.shadow))


def sample_snapshot(cfg: TrainConfig, sde, model, state, step_i: int, dev):
    """EMA-weight sampling snapshot (reference ``run_lib.py:155-173``): 64
    images by the PC sampler (its N is ``sample_steps`` when given), saved
    as ``samples/iter_<step>.png``."""
    _, pc_kw = _SDES[cfg.sde]
    if cfg.sample_steps is not None:
        sde = dataclasses.replace(sde, N=cfg.sample_steps)
    apply = functional_apply(model)
    shadow = ema_params(model, state)
    score_fn = get_score_fn(sde, lambda x, tl: apply(shadow, x, tl))
    sampler = get_pc_sampler(sde, score_fn, (64, 32, 32, 3), device=dev,
                             **pc_kw)
    x, _ = sampler(torch.Generator(device=dev).manual_seed(step_i))
    inv = get_inverse_scaler(True)
    save_image_grid(inv(x).float().cpu().numpy(),
                    os.path.join(cfg.workdir, "samples",
                                 f"iter_{step_i}.png"),
                    value_range=(0.0, 1.0))


@torch.no_grad()
def evaluate(cfg: TrainConfig) -> dict:
    """Eval-split loss of the EMA parameters (``run_lib.py:175-240``'s
    core), and with ``bpd`` the probability-flow bits/dim."""
    from ..train.losses import sde_loss_fn
    sde, model, _, state, dev = setup(cfg)
    apply = functional_apply(model)
    shadow = ema_params(model, state)
    it = get_dataset(cfg.dataset, cfg.batch, data_dir=cfg.data_dir,
                     split="test")
    losses = []
    for i in range(16):
        images, _ = next(it)
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        losses.append(float(sde_loss_fn(
            sde, apply, shadow, torch.Generator(device=dev).manual_seed(i),
            batch)))
    out = {"eval_loss": float(np.mean(losses))}
    print(f"eval loss (EMA, {len(losses)} batches): {out['eval_loss']:.5f}")

    if cfg.bpd:
        # prob-flow ODE bits/dim (reference run_lib.py:241-260 BPD pass)
        from ..eval.likelihood import get_likelihood_fn
        score_fn = get_score_fn(sde, lambda x, tl: apply(shadow, x, tl))
        lik = get_likelihood_fn(sde, score_fn,
                                inverse_scaler=get_inverse_scaler(True))
        bpds = []
        for i in range(4):
            images, _ = next(it)
            batch = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
            bpd, _, nfe = lik(torch.Generator(device=dev).manual_seed(100 + i),
                              batch)
            bpds.append(float(bpd.mean()))
            print(f"  bpd batch {i}: {bpds[-1]:.4f} (nfe {int(nfe)})")
        out["bpd"] = float(np.mean(bpds))
        print(f"eval bpd (EMA, {len(bpds)} batches): {out['bpd']:.4f}")
    return out


def parse(argv=None) -> tuple[TrainConfig, str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--mode", choices=("train", "eval"), default="train")
    p.add_argument("--sde", choices=sorted(_SDES), default="vpsde")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n-iters", type=int, default=1_300_001)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup", type=int, default=5000)
    p.add_argument("--snapshot-freq", type=int, default=50_000)
    p.add_argument("--preemption-freq", type=int, default=10_000)
    p.add_argument("--log-freq", type=int, default=50)
    p.add_argument("--donate", action="store_true",
                   help="accepted for the JAX driver's command lines; the "
                        "port's step updates the state in place")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the state over a mesh (not ported: raises)")
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--ch-mult", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(1, 2, 2, 2))
    p.add_argument("--num-res-blocks", type=int, default=4)
    p.add_argument("--no-snapshot-samples", action="store_true")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="the snapshot sampler's N (default: the SDE's)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward and backward with f32 master "
                        "parameters, moments and EMA (default: the "
                        "reference's f32)")
    p.add_argument("--bpd", action="store_true",
                   help="also report prob-flow bits/dim in eval mode")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = TrainConfig(
        workdir=args.workdir, sde=args.sde, dataset=args.dataset,
        data_dir=args.data_dir, batch=args.batch, n_iters=args.n_iters,
        lr=args.lr, warmup=args.warmup, snapshot_freq=args.snapshot_freq,
        preemption_freq=args.preemption_freq, log_freq=args.log_freq,
        nf=args.nf, ch_mult=args.ch_mult,
        num_res_blocks=args.num_res_blocks,
        sample_at_snapshot=not args.no_snapshot_samples,
        sample_steps=args.sample_steps, bpd=args.bpd, bf16=args.bf16,
        donate=args.donate, fsdp=args.fsdp, device=args.device)
    return cfg, args.mode


def main(argv=None) -> int:
    cfg, mode = parse(argv)
    (train if mode == "train" else evaluate)(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
