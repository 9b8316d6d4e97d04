"""One-command reproduction driver (port of
``naturaldiffusion_tpu/apps/repro_all.py``).

Regenerates the repository's headline artifacts from scratch through the
port's own apps, each a child process of its own:

    python -m naturaldiffusion_tpu_torch.apps.repro_all --out results_repro

By default every step runs on the CPU (each app that has the flag is
passed ``--device cpu``): the coefficient corpus, the analyzers' NI ==
solver validation, the DiT NI validation, a toy-scale FID self-check and
the coefficient-matrix page.  ``--chip`` adds the card's steps, which run
on the card (the apps' default device): the port bench
(``apps.bench``, the headline workload), the W8A8 op micro-bench, the
int8 accuracy report and one DEIS sweep cell.  No step imports JAX.

Each step writes its log under ``<out>/logs/``; a table (step, rc,
seconds) prints as the steps end, ``<out>/repro_summary.json`` holds it,
and the exit code is the number of failed steps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PKG = "naturaldiffusion_tpu_torch"


def _mod(mod: str, *args: str):
    """The command that runs ``<PKG>.<mod>`` as ``__main__``."""
    return [sys.executable, "-m", f"{PKG}.{mod}", *args]


def _steps(out: str, chip: bool, quick: bool):
    cpu = ("--device", "cpu")
    steps = [
        ("corpus", _mod("apps.analyze", "--all", "--outdir",
                        f"{out}/corpus")),
        ("validate_analyzers", _mod("apps.validate", *cpu)),
        ("validate_dit", _mod("apps.validate_dit", "--small", "--steps",
                              "8", *cpu)),
        ("fid_selfcheck_toy", _mod(
            "apps.fid_selfcheck", "--toy", "--num", "256", "--batch", "128",
            "--micro", "64", "--steps", "5",
            "--out", f"{out}/FID/selfcheck_toy.csv", *cpu)),
        ("visualize", _mod("viz.visualize",
                           f"{out}/corpus/VisualizeCoeffMatrix.html")),
    ]
    if chip:
        steps += [
            ("bench_headline", _mod("apps.bench")),
            ("bench_quant_ops", _mod("apps.bench_quant_ops", "--reps", "20",
                                     "--runs", "5")),
            ("quant_accuracy", _mod("apps.quant_accuracy",
                                    "--out", f"{out}/quant_accuracy.json")),
            ("sweep_cell", _mod("apps.sweep", "--family", "deis", "--num",
                                "256", "--batch", "256",
                                "--only", "t:t_ab:1",
                                "--out", f"{out}/FID/repro_deis_cell.csv")),
        ]
    return steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="results_repro")
    p.add_argument("--chip", action="store_true",
                   help="also run the card's steps (the benches)")
    p.add_argument("--quick", action="store_true",
                   help="reserved for CI: currently identical to default")
    a = p.parse_args(argv)

    os.makedirs(f"{a.out}/logs", exist_ok=True)
    os.makedirs(f"{a.out}/FID", exist_ok=True)
    rows = []
    for name, cmd in _steps(a.out, a.chip, a.quick):
        log = f"{a.out}/logs/{name}.log"
        t0 = time.time()
        with open(log, "w") as fh:
            rc = subprocess.call(cmd, stdout=fh, stderr=subprocess.STDOUT)
        rows.append({"step": name, "rc": rc,
                     "seconds": round(time.time() - t0, 1), "log": log})
        print(f"{name:24s} rc={rc} {rows[-1]['seconds']:8.1f}s", flush=True)

    with open(f"{a.out}/repro_summary.json", "w") as fh:
        json.dump(rows, fh, indent=1)
    failed = sum(1 for r in rows if r["rc"] != 0)
    print(f"repro_all: {len(rows) - failed}/{len(rows)} steps ok "
          f"-> {a.out}/repro_summary.json")
    return failed


if __name__ == "__main__":
    raise SystemExit(main())
