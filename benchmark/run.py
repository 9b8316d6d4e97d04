"""Run one benchmark cell of the port on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON; the numbers the
check compared, each beside its limit, are the last lines of standard
error.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
