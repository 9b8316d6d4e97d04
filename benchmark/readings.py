"""The readings a cell's limits are set from, on the card at the cell's own
size, several seeds in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        [--seconds 1] [--control]

Without ``--control`` each seed is one run of the cell as ``run.py`` makes
it (a short window), and its line holds the numbers the check compared:
the program's sound readings.  With ``--control`` the reference computed
in float8 e4m3 takes the program's place on the same requests and is
checked as the program would be.  One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness import core
    from benchmark.harness.control import control_checks
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control:
            checks = control_checks(args.workload, seed)
            torch.cuda.empty_cache()
            line = {"seed": seed, "control": "fp8_e4m3",
                    "checks": {n: v for n, v, _ in checks}}
        else:
            r = core.run_cell(args.workload, seed, args.seconds, False,
                              t_start=t0)
            line = {"seed": seed, "correct": r["correct"],
                    "checks": {n: c["value"] for n, c in r["checks"].items()},
                    "metrics": {n: m["value"] for n, m in
                                r["metrics"].items()}}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
