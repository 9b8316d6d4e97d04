"""Accuracy budget of the W8A8 int8 inference path (port of
``naturaldiffusion_tpu/apps/quant_accuracy.py``).

The 10-step NI trajectory of the CIFAR-10 NCSN++ runs three ways: the fp64
host-loop oracle (``engine.ni.natural_inference_reference`` around the f32
model on the device), the bf16 engine, and the bf16 engine with the int8
convs (``--mode``, ``NATDIFF_QUANT``), all from one init and one set of
per-step noises; the report gives the pairwise errors of the final images.
The bf16-against-oracle gap is the float path's own noise floor; int8 is
acceptable when its extra error is of the same order (it adds ~1/254
rounding per operand on top of bf16's ~1/256 quantum).

All three run under ``NATDIFF_PALLAS_CONV=0``, the JAX package's default
route (as ``apps.bench.form_env`` sets it): under the port's default ``2``
the fused resblock kernel returns before the int8 dispatch, and the int8
run would equal the bf16 run.

    python -m naturaldiffusion_tpu_torch.apps.quant_accuracy \\
        [--mode int8_static] [--out results_torch/quant_accuracy.json]

CAVEAT (the JAX package's, measured there): random-init runs UNDERSTATE
quantization noise by orders of magnitude.  Every resblock's Conv_1 is
zero-init (``init_scale=0.0``, the reference's convention), so at random
init the residual branches contribute almost nothing and the quantization
noise of Conv_0/NIN is annihilated before it reaches the output (an
int8-against-bf16 MAE ~1e-6 at init against ~1e-2 trained).  Runs of the
init document finiteness only; a caller that passes a model with every
weight random (``run(args, model=...)``) sees the noise.  ``--workdir``
takes the EMA weights of a training state (``apps.train``'s
``checkpoints-meta``), as the JAX app does, and adds the sample-quality
delta of the toy dataset's marginals (``w1_delta``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

from ..coeffs import registry
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..engine.ni import natural_inference_reference
from ..models.ncsnpp import NCSNpp, NCSNppConfig
from .bench import form_env

MODES = ("int8", "int8_static", "int8_all", "int8_all_static")


def _mae(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--ch-mult", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(1, 2, 2, 2))
    p.add_argument("--num-res-blocks", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--mode", default="int8", choices=MODES)
    p.add_argument("--workdir", default=None,
                   help="apps.train workdir (EMA weights); random init "
                        "when absent or empty")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


@torch.no_grad()
def load_ema(model, workdir: str) -> str:
    """Fill ``model`` with the EMA weights of the training state in
    ``workdir`` (restored over a template of its own parameters; a missing
    checkpoint warns and leaves it as it is); returns the weights' source,
    ``ema_step<N>`` or ``random``."""
    from ..sde import VPSDE
    from ..train import checkpoint as ckpt
    from ..train import make_train_step
    from ..train.state import functional_apply
    init_fn, _ = make_train_step(VPSDE(), functional_apply(model))
    params = dict(model.named_parameters())
    state = ckpt.restore(workdir, init_fn(params))
    if state.step == 0:
        return "random"
    for p, s in zip(params.values(), state.ema.shadow):
        p.copy_(s)
    return f"ema_step{state.step}"


def trajectories(args, model=None):
    """The final images ``(bf16, int8, fp64 oracle)`` of ``args`` (from
    :func:`parse_args`) as float numpy arrays, over ``model`` (an NCSN++ at
    32², float32) when given, else a new one from seed 1 (with
    ``args.workdir``'s EMA weights where it holds a training state).  The
    init and the per-step noises are drawn on the CPU from
    ``torch.Generator`` seeds 0 and 9."""
    dev = resolve_device(args.device)
    if model is None:
        model = NCSNpp(NCSNppConfig(nf=args.nf, ch_mult=args.ch_mult,
                                    num_res_blocks=args.num_res_blocks),
                       device=dev, seed=1)
        args.weights = (load_ema(model, args.workdir) if args.workdir
                        else "random")
    net16 = copy.deepcopy(model).to(device=dev, dtype=torch.bfloat16).eval()
    net32 = copy.deepcopy(model).to(device=dev, dtype=torch.float32).eval()
    m = registry.derive("ddpm", args.steps)
    sched = NISchedule.from_matrix(m, device=dev)
    shape = (args.batch, 32, 32, 3)
    z0 = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    # one set of per-step noises, so that all three walk one trajectory
    noises = torch.randn((args.steps,) + shape,
                         generator=torch.Generator().manual_seed(9))

    def eps_bf16(z, t):
        return net16(z, t.reshape(1).expand(z.shape[0]))

    @torch.no_grad()
    def engine(quant):
        with form_env("0", quant):
            out = natural_inference(eps_bf16, sched, z0.to(dev),
                                    prediction_type="eps",
                                    model_dtype=torch.bfloat16,
                                    noises=noises.to(dev))
        return out.float().cpu().numpy()

    @torch.no_grad()
    def f32_fwd(z, t):
        z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        with form_env("0", ""):
            out = net32(z, torch.full((z.shape[0],), float(t),
                                      dtype=torch.float32, device=dev))
        return out.cpu().numpy()

    out_bf16 = engine("")
    out_int8 = engine(args.mode)
    oracle = natural_inference_reference(f32_fwd, m, z0.numpy(),
                                         noises=noises.numpy(),
                                         prediction_type="eps")
    return out_bf16, out_int8, oracle


def run(args, model=None) -> dict:
    """The report of :func:`trajectories`: the pairwise errors of the final
    images, with the JAX app's keys."""
    out_bf16, out_int8, oracle = trajectories(args, model)
    i8_bf, i8_bf_max = _mae(out_int8, out_bf16)
    bf_or, bf_or_max = _mae(out_bf16, oracle)
    i8_or, i8_or_max = _mae(out_int8, oracle)
    weights = getattr(args, "weights", "random")
    report = {
        "weights": weights, "mode": args.mode,
        "steps": args.steps, "batch": args.batch,
        "output_mean_abs": round(float(np.abs(oracle).mean()), 5),
        "mae_int8_vs_bf16": i8_bf, "max_int8_vs_bf16": i8_bf_max,
        "mae_bf16_vs_fp64oracle": bf_or, "max_bf16_vs_fp64oracle": bf_or_max,
        "mae_int8_vs_fp64oracle": i8_or, "max_int8_vs_fp64oracle": i8_or_max,
        "int8_extra_error_ratio": round(i8_or / max(bf_or, 1e-30), 3),
        "finite": bool(np.isfinite(out_int8).all()),
    }
    if weights != "random":
        # population-level sample-quality delta (the toy marginals' W1)
        from .toy_dataset import summary_stats, wasserstein1
        sb = summary_stats(np.clip((out_bf16 + 1) / 2, 0, 1))
        si = summary_stats(np.clip((out_int8 + 1) / 2, 0, 1))
        report["w1_delta"] = {k: round(wasserstein1(sb[k], si[k]), 6)
                              for k in sb}
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run(args)
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0 if report["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
