"""CIFAR-10 sampler sweeps (port of ``naturaldiffusion_tpu/apps/sweep.py``):
the reference's FID grid scripts (``deis_sampling_tx``,
``src/CIFAR10NaturalInference.py:122-238``, and ``dpm_solver_tx``,
``:331-412``) as one CLI, over the full-width ``CIFAR10_DDPMPP_CONTINUOUS``
in bf16 through the port's kernels.

Grids (the JAX package's, the reference's):

* deis: ts_phase in {t, rho} x method in {t_ab, rho_ab, rho_rk, ipndm} x
  ab_order in {1, 2, 3} (rho_rk and ipndm at 3 only, ipndm at t only);
* dpmsolver / dpmsolverpp: method in {singlestep, multistep} x order in
  {1, 2, 3}.

Each cell samples ``--num`` images in batches of ``--batch``, run in
micro-batches of ``--micro``, and writes one CSV row: ``weights``
(``converted`` with ``--ckpt``, else ``random``), the cell's keys,
``img_per_sec`` (steady state: the first batch is excluded, nan with one
batch), ``wall_s`` (the cell's whole time), ``finite``, and with
``--fid-stats`` (an npz of ``mu``/``sigma``) ``inception`` and ``fid``:
the FID of all the cell's samples through ``eval.fid.fid_from_samples``,
its Inception ``converted`` from ``--inception`` (a
``pt_inception-2015-12-05.pth``) or else ``random`` (the pipeline, not a
real FID: the repository holds no such file).  The CSV is rewritten after
every cell.

    python -m naturaldiffusion_tpu_torch.apps.sweep --family dpmsolverpp \\
        --num 128 --batch 64 --only multistep:2 --out sweep.csv
"""

from __future__ import annotations

import argparse
import copy
import csv
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.ncsnpp import CIFAR10_DDPMPP_CONTINUOUS, NCSNpp
from ..samplers import deis as deis_mod
from ..samplers.dpm_solver import DPMSolver, NoiseScheduleVP, model_wrapper
from ..schedules import LinearVPSDE, PiecewiseVPSDE


def _model(args, model=None):
    """``raw(x, t_cont) -> eps`` in float32: the NCSN++ (``model``, else a
    new one from ``--seed``, filled from ``--ckpt`` when given) as a bf16
    copy on the device, with the continuous VP label ``t * 999``."""
    dev = resolve_device(args.device)
    if model is None:
        model = NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device=dev, seed=args.seed)
        if args.ckpt:
            from ..models.convert import fill_from_torch, load_torch_checkpoint
            fill_from_torch(model, load_torch_checkpoint(args.ckpt))
    net = copy.deepcopy(model).to(device=dev, dtype=torch.bfloat16).eval()

    def raw(x, t_cont):
        return net(x.to(torch.bfloat16), t_cont * 999.0).float()

    return raw


def _microbatch(fn, micro: int):
    """Run ``fn`` over chunks of ``micro`` images, one after another, when
    ``micro`` divides the batch and is smaller."""
    def run(x):
        bb = x.shape[0]
        if not micro or bb % micro or bb <= micro:
            return fn(x)
        return torch.cat([fn(x[c:c + micro]) for c in range(0, bb, micro)])
    return run


def _filter_cells(args, cells):
    if not getattr(args, "only", None):
        return cells
    want = args.only.split(":")
    out = [c for c in cells if [str(v) for v in c.values()] == want]
    if not out:
        raise SystemExit(f"--only {args.only!r} matches no cell of "
                         f"{[':'.join(str(v) for v in c.values()) for c in cells]}")
    return out


def _make_runner(s, micro, device):
    """A cell's sampler over micro-batches.  A sampler with ``run`` and
    ``run_args`` (the DEIS AB families) gets its tables on the device once,
    as float32 tensors."""
    if not hasattr(s, "run"):
        return _microbatch(s, micro)
    data = tuple(torch.as_tensor(np.asarray(a, np.float64)).to(
        dtype=torch.float32, device=device) for a in s.run_args)
    run = s.run
    return _microbatch(lambda x: run(x, *data), micro)


@torch.no_grad()
def _sample_cells(args, cells, build_sampler, sink=None):
    dev = resolve_device(args.device)
    rows = []
    for cell in _filter_cells(args, cells):
        cell_t0 = time.time()
        sampler = _make_runner(build_sampler(cell), args.micro, dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        finite, t0, first, done = True, None, 0, 0
        imgs = []
        while done < args.num:
            b = min(args.batch, args.num - done)
            x = torch.randn((b, 32, 32, 3), generator=gen, device=dev)
            out = sampler(x)
            finite = finite and bool(torch.isfinite(out).all())  # syncs
            if args.fid_stats:
                imgs.append(out)
            done += b
            if t0 is None:          # exclude the first batch (time and images)
                t0, first = time.time(), done
        rate = (done - first) / max(time.time() - t0, 1e-9) \
            if done > first else float("nan")
        row = {"weights": "converted" if args.ckpt else "random", **cell}
        row["img_per_sec"] = round(rate, 2)
        row["wall_s"] = round(time.time() - cell_t0, 1)
        row["finite"] = finite
        if args.fid_stats:
            from ..eval.fid import fid_from_samples
            from ..eval.inception import default_feature_fn
            row["inception"] = "converted" if args.inception else "random"
            row["fid"] = round(fid_from_samples(
                torch.cat(imgs), args.fid_stats, feature_fn=(
                    default_feature_fn(args.inception, device=dev))), 3)
        rows.append(row)
        print(row, flush=True)
        if sink is not None:
            sink(rows)
    return rows


def deis_cells():
    cells = []
    for ts_phase in ("t", "rho"):
        for method in ("t_ab", "rho_ab", "rho_rk", "ipndm"):
            if method == "ipndm" and ts_phase != "t":
                continue
            for order in (1, 2, 3):
                if method == "rho_rk" and order != 3:
                    continue   # the rk grid is keyed by tableau, not ab_order
                if method == "ipndm" and order != 3:
                    continue   # ipndm has no order knob (fixed AB-3 ramp)
                cells.append({"ts_phase": ts_phase, "method": method,
                              "ab_order": order})
    return cells


def dpmsolver_cells(steps: int):
    return [{"method": m, "order": o}
            for m in ("singlestep", "multistep") for o in (1, 2, 3)
            if not (m == "multistep" and o > steps)]


def sweep_deis(args, model=None, sink=None):
    raw = _model(args, model)
    if args.discrete:
        # the reference builds DEIS on DiscreteVPSDE from the model's alphas
        # (src/CIFAR10NaturalInference.py:122-160); time = integer steps
        sde = PiecewiseVPSDE.from_betas(np.linspace(0.1 / 1000, 20.0 / 1000,
                                                    1000))
    else:
        sde = LinearVPSDE()
    # the model's label: continuous t * 999, or the discrete step itself
    scale = 1.0 / 999.0 if args.discrete else 1.0

    def eps_fn(x, t):
        return raw(x, (t.float() * scale).expand(x.shape[0]))

    t0 = 0.0 if args.discrete else 1e-3

    def build(cell):
        if cell["method"] == "ipndm":
            return deis_mod.get_sampler_ipndm(sde, eps_fn, args.steps, t0=t0)
        return deis_mod.get_sampler(
            sde, eps_fn, cell["ts_phase"], 2.0, args.steps,
            method=cell["method"], ab_order=cell["ab_order"],
            rk_method="3kutta", t0=t0)

    return _sample_cells(args, deis_cells(), build, sink)


def sweep_dpmsolver(args, algorithm: str, model=None, sink=None):
    raw = _model(args, model)
    ns = NoiseScheduleVP(schedule="linear")
    solver = DPMSolver(model_wrapper(raw, ns, model_type="noise"), ns,
                       algorithm_type=algorithm)

    def build(cell):
        return lambda x: solver.sample(
            x, steps=args.steps, order=cell["order"],
            method=cell["method"], t_end=1e-3)

    return _sample_cells(args, dpmsolver_cells(args.steps), build, sink)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=("deis", "dpmsolver", "dpmsolverpp"),
                   required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--num", type=int, default=512)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--micro", type=int, default=64,
                   help="images per chunk inside a batch (0 = whole batch)")
    p.add_argument("--seed", type=int, default=888)
    p.add_argument("--ckpt", default=None, help="torch checkpoint_8.pth")
    p.add_argument("--only", default=None,
                   help="run one cell: 'method:order' (dpm families) or "
                        "'ts_phase:method:order' (deis)")
    p.add_argument("--discrete", action="store_true",
                   help="DEIS on the piecewise discrete-alpha schedule "
                        "(the reference FID-sweep setup)")
    p.add_argument("--out", default=None,
                   help="CSV path (default <family>_<steps>step_sweep.csv)")
    p.add_argument("--fid-stats", default=None,
                   help="npz with mu/sigma (cifar10_mu_sigma.npz layout)")
    p.add_argument("--inception", default=None,
                   help="pt_inception-2015-12-05.pth for --fid-stats "
                        "(random weights if omitted: not a real FID)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args, model=None) -> list[dict]:
    """The sweep of ``args`` (from :func:`parse_args`), over ``model`` when
    given; writes the CSV and returns its rows."""
    out = args.out or f"{args.family}_{args.steps}step_sweep.csv"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def sink(rows):
        with open(out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)

    if args.family == "deis":
        rows = sweep_deis(args, model, sink)
    else:
        rows = sweep_dpmsolver(
            args, "dpmsolver" if args.family == "dpmsolver"
            else "dpmsolver++", model, sink)
    print(f"-> {out}", flush=True)
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
