"""The control: the reference computed one precision below the
configuration's (float8 e4m3 for bfloat16), put in the program's place
and checked as the program's answers are."""

from __future__ import annotations

from benchmark.reference.precision import CONTROL

from .core import BENCH, ROOT, load_file, read_json


def control_checks(cell, seed, device="cuda", spec_override=None,
                   traffic_override=None):
    """``[(name, value, limit)]`` of the control on the cell's first
    ``check_answers`` answers under ``seed``."""
    bench = read_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    traffic = dict(read_json(BENCH / "workloads" / f"{entry['traffic']}.json"),
                   **(traffic_override or {}))
    spec = dict(read_json(BENCH / "configs" / f"{entry['config']}.json"),
                **(spec_override or {}))
    cfg = load_file(BENCH / "configs" / f"{entry['config']}.py", "config")
    checker = cfg.make_checker(spec, traffic, seed, device)
    n = int(traffic["check_answers"])
    if hasattr(checker, "reference_answer"):
        keys = [(0, j) for j in range(n)]
        got = {k: checker.reference_answer(k, CONTROL) for k in keys}
    else:
        keys = [(i, 0) for i in range(n)]
        got = checker.reference_answers(keys, CONTROL)
    return checker.check(got, keys)
