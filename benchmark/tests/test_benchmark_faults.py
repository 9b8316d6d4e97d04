"""The check sees the faults the cells can have: a whole run at toy size on
the CPU (the look for a card skipped) with the port's NI engine broken
underneath comes out not correct.

* ``state_unchanged``: one step returns its state unchanged;
* ``answer_altered``: the last step's output of one image is scaled by 2,
  where the answer is produced.
(Half a batch left out of a mean, and an exchange between chips, have no
place in these inference cells: no step averages over the batch and every
cell runs on one card.)"""

import time

import pytest

from benchmark.harness.core import ROOT, read_json, run_cell
from bench_toy import overrides

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]


def broken(fault):
    from naturaldiffusion_tpu_torch.engine import ni
    real = ni.fused_weighted_sum
    last = {}

    def step(wx, we, bufx, bufe, live_x, live_e):
        z = real(wx, we, bufx, bufe, live_x, live_e)
        n = bufx.shape[0]
        if fault == "state_unchanged" and live_x == 2:
            z = last["z"]
        elif fault == "answer_altered" and live_x == n:
            z = z.clone()
            z[: z.numel() // 8] *= 2.0
        last["z"] = z
        return z
    return ni, step


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    mod, step = broken(fault)
    monkeypatch.setattr(mod, "fused_weighted_sum", step)
    spec, traffic = overrides(cell)
    r = run_cell(cell, 2 ** 31 + 3, 0.05, False, t_start=time.perf_counter(),
                 device="cpu", spec_override=spec, traffic_override=traffic)
    assert r["correct"] is False, r["checks"]
