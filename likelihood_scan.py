#!/usr/bin/env python3
"""How well-posed the likelihood check of ``chip_smoke.py`` is, on one
card: ``eval.likelihood.get_likelihood_fn`` over the full-width CIFAR-10
NCSN++ (every weight random from chip_smoke's seed), f32, batch 2, at
rtol = atol = 1e-3, with the model's eps scaled by ``s`` and the ODE
started at ``t0``, for each (s, t0) of ``POINTS``.

At each point, four runs from the same data and Rademacher probe:

* ``base``: the plain versions of the kernels (K2, K3, K6);
* ``tiny``: the same with eps 1e-6 larger (how far a rounding-sized
  change of the model moves bits/dim and the latent z);
* ``control``: the same with the time labels 1 % off (what a small fault
  moves);
* ``kernels``: the kernels.

It prints, for each point, the nfe and seconds of each run and the
relative error of bpd and the relative L2 of z of each run against
``base``.  The model calls replay CUDA graphs (``chip_smoke.GraphedVJP``).

    python3 likelihood_scan.py [--out FILE.json]

Needs a card and ``nvcc``; run it from the repository's root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (eps scale, start time): unscaled at JAX's start, then scales at JAX's
# start and at 1e-3 (chip_smoke's likelihood phase: 0.003 from 1e-3)
POINTS = ((1.0, 1e-5), (0.1, 1e-5), (0.01, 1e-5), (0.003, 1e-5),
          (0.002, 1e-5), (0.003, 1e-3), (0.01, 1e-3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import chip_smoke as C
    from naturaldiffusion_tpu_torch.eval.likelihood import get_likelihood_fn
    from naturaldiffusion_tpu_torch.models.ncsnpp import (
        CIFAR10_DDPMPP_CONTINUOUS, NCSNpp)
    from naturaldiffusion_tpu_torch.scaler import get_inverse_scaler
    from naturaldiffusion_tpu_torch.sde import VPSDE, get_score_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    sde = VPSDE()
    net = C.randomize_(NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu"),
                       C.SEED).to("cuda").eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(C.LIK_SEED)
    data = torch.rand((C.ODE_BATCH, 32, 32, 3), generator=gen,
                      device="cuda") * 2 - 1
    probe = torch.randint(0, 2, data.shape, generator=gen,
                          device="cuda") * 2.0 - 1.0

    def run(g, scale, t_scale, t0):
        lik = get_likelihood_fn(
            sde, get_score_fn(sde, lambda x, lab: scale * g(x, lab * t_scale)),
            rtol=C.ODE_RTOL, atol=C.ODE_RTOL, eps=t0,
            inverse_scaler=get_inverse_scaler(True))
        t = time.perf_counter()
        bpd, z, nfe = lik(None, data, probe=probe)
        torch.cuda.synchronize()
        return bpd, z, nfe, time.perf_counter() - t

    kernels = C.GraphedVJP(net)
    with C.plain_convs_and_norms():
        plain = C.GraphedVJP(net)
        run(plain, 1.0, 1.0, 1e-3)                  # capture
    rows = []
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for s, t0 in POINTS:
        runs = {"base": run(plain, s, 1.0, t0),
                "tiny": run(plain, s * (1 + 1e-6), 1.0, t0),
                "control": run(plain, s, 1.01, t0),
                "kernels": run(kernels, s, 1.0, t0)}
        bpd, z = runs["base"][:2]
        row = dict(eps_scale=s, t0=t0,
                   nfe={k: r[2] for k, r in runs.items()},
                   seconds={k: r[3] for k, r in runs.items()},
                   bpd=bpd.tolist())
        for k in ("tiny", "control", "kernels"):
            row[k] = dict(
                bpd_rel_err=float(((runs[k][0] - bpd).abs() / bpd.abs())
                                  .max()),
                z_rel_l2=C.rel_l2(runs[k][1], z))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
