"""Batch coefficient-matrix derivation (port of
``naturaldiffusion_tpu/apps/analyze.py``, the ``src/Analyze*.py`` family as
one command).  Host numpy only: it runs no model and needs no card.

    python -m naturaldiffusion_tpu_torch.apps.analyze --alg ddpm --outdir out
    python -m naturaldiffusion_tpu_torch.apps.analyze --all --no-plot

For every (algorithm, step count) it derives the matrix, checks the
natural-marginal invariant, and writes the npz triple, the rounded CSV
and, unless ``--no-plot``, the marginal plot (matplotlib), as
``save_coeff_matrix`` does (``src/Utils.py:30-53``), under
``<outdir>/<result_dir>/<prefix>_<rows>.{npz,csv,jpg}``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..coeffs import registry


def analyze(alg: str, steps: list[int] | None, outdir: str,
            plot: bool = True) -> None:
    spec = registry.DERIVERS[alg]
    steps = steps or list(spec.step_counts)
    for n in steps:
        t0 = time.time()
        m = spec.fn(n)
        sig_err, noi_err = m.marginal_errors()
        rows = n * spec.rows_per_step
        base = os.path.join(outdir, spec.result_dir,
                            f"{spec.prefix}_{rows:03d}")
        m.save(base + ".npz")
        m.save_csv(base + ".csv")
        if plot:
            from ..utils.plotting import draw_marginal_coeff
            draw_marginal_coeff(m, base + ".jpg")
        print(f"{alg:<22s} n={n:<4d} rows={rows:<4d} "
              f"sig_err={sig_err.max():.2e} noi_err={noi_err.max():.2e} "
              f"({time.time() - t0:.2f}s) -> {base}.npz", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--alg", choices=sorted(registry.DERIVERS), default=None)
    p.add_argument("--all", action="store_true",
                   help="derive every registered algorithm")
    p.add_argument("--steps", type=lambda s: [int(x) for x in s.split(",")],
                   default=None, help="comma-separated step counts "
                   "(default: the reference-shipped grids)")
    p.add_argument("--outdir", default="results_torch")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)

    algs = sorted(registry.DERIVERS) if args.all else (
        [args.alg] if args.alg else [])
    if not algs:
        p.error("need --alg or --all")
    for alg in algs:
        analyze(alg, args.steps, args.outdir, plot=not args.no_plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
