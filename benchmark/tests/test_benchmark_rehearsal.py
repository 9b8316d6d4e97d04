"""Each cell rehearsed on the CPU at toy size: the whole run (set-up, the
window, the traced stretch, the check, the result line), with the port's
plain versions in place of its kernels and no graph."""

import json
import subprocess
import sys
import time

import pytest

from benchmark.harness.core import BENCH, ROOT, read_json, run_cell
from bench_toy import overrides

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_toy_size(cell):
    spec, traffic = overrides(cell)
    r = run_cell(cell, 2 ** 31 + 11, 0.2, True, t_start=time.perf_counter(),
                 device="cpu", spec_override=spec, traffic_override=traffic)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and r["checks"]
    json.dumps(r)
    for name, m in r["metrics"].items():
        assert m["value"] == m["value"], name


@pytest.mark.parametrize("cell", ["cifar10-ni10-b64", "sd3m-1024-t2i"])
def test_same_seed_same_inputs(cell):
    """A request's inputs come from the seed and its index alone."""
    import torch
    from benchmark.harness.core import load_file
    entry = next(w for w in read_json(ROOT / "BENCHMARK.json")["workloads"]
                 if w["name"] == cell)
    cfg = load_file(BENCH / "configs" / f"{entry['config']}.py", "config")
    spec, traffic = overrides(cell)
    spec = dict(read_json(BENCH / "configs" / f"{entry['config']}.json"),
                **spec)
    traffic = dict(read_json(BENCH / "workloads" / f"{entry['traffic']}.json"),
                   **traffic)

    def flat(i):
        out, todo = [], [cfg.request_inputs(spec, traffic, 2 ** 31 + 5, i,
                                            "cpu")]
        while todo:
            x = todo.pop()
            if isinstance(x, torch.Tensor):
                out.append(x)
            else:
                todo.extend(x)
        return out
    a, b, c = flat(3), flat(3), flat(4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_same_seed_same_weights():
    import torch
    from benchmark.harness.weights import fill_
    from benchmark.reference.ncsnpp import NCSNpp
    m1, m2 = (fill_(NCSNpp(nf=32, ch_mult=(1, 2), num_res_blocks=1,
                           attn_resolutions=(8,), image_size=16), 9,
                    torch.bfloat16, "cpu") for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                 m2.parameters()))


def test_no_card_no_result(tmp_path):
    """Without a card (here), or in a checkout that holds only
    BENCHMARK.json and ``benchmark/``, the command exits non-zero and
    prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "cifar10-ni10-b64", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
