"""The control (the reference in float8 e4m3 in the program's place) comes
out not correct, and the program correct, on three seeds: on the CPU at
toy size with the toy limits, and on the card (marked ``card``) at the
same toy size.  The cells' own readings and limits, at their own sizes on
the card, are in PERF.md (``benchmark/readings.py``)."""

import time

import pytest

from benchmark.harness.control import control_checks
from benchmark.harness.core import ROOT, read_json, run_cell
from bench_toy import overrides

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]
SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)


def fails(checks):
    return any(not v <= lim for _, v, lim in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_cpu(cell):
    spec, traffic = overrides(cell)
    for seed in SEEDS:
        assert fails(control_checks(cell, seed, "cpu", spec, traffic))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(card, cell):
    spec, traffic = overrides(cell)
    for seed in SEEDS:
        assert fails(control_checks(cell, seed, "cuda", spec, traffic))
        r = run_cell(cell, seed, 0.2, False, t_start=time.perf_counter(),
                     device="cuda", spec_override=spec,
                     traffic_override=traffic)
        assert r["correct"], r["checks"]
