"""A configuration, a traffic mix and a metric added as new files only:
a copy of the benchmark, with a toy configuration that runs no port code,
gains a cell without an edit to any file already there, and the cell runs.
"""

import json
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness.core import BENCH, ROOT

NEW = {
    "configs/toy-mlp.json": {"name": "toy-mlp", "width": 8},
    "workloads/toy-mix.json": {"rows": 4, "check_answers": 2,
                               "limits": {"rel_l2": 1e-6}},
    "configs/toy-mlp.py": '''
        import torch
        from benchmark.harness.inputs import rel_l2, request_generator

        class Toy:
            def __init__(self, spec, traffic, seed, device):
                self.spec, self.traffic, self.seed = spec, traffic, seed
                g = torch.Generator().manual_seed(seed)
                w = spec["width"]
                self.weight = torch.randn(w, w, generator=g)

            def setup(self, wait_build):
                wait_build()

            def x(self, i):
                g = request_generator(self.seed, i, "cpu")
                return torch.randn(self.traffic["rows"], self.spec["width"],
                                   generator=g)

            def run(self, i, spans):
                spans.setdefault("mm", []).append(1e-3)
                return [torch.tanh(self.x(i) @ self.weight)]

            def images(self, answers):
                return sum(a.shape[0] for a in answers)

            def free(self):
                pass

            def check(self, answers, keys):
                worst = max(rel_l2(answers[k], torch.tanh(
                    self.x(k[0]).double() @ self.weight.double()))
                    for k in keys)
                return [("rel_l2", worst, self.traffic["limits"]["rel_l2"])]

        def make(spec, traffic, seed, device):
            return Toy(spec, traffic, seed, device)

        make_checker = make
    ''',
    "counts/toy-mlp.py": '''
        def request_flops(spec, traffic):
            return 2 * traffic["rows"] * spec["width"] ** 2
    ''',
    "metrics/rows_per_s.py": '''
        def read(ctx):
            return ctx.images / ctx.window_s
    ''',
    "metrics/mm_ms.toy.py": '''
        from benchmark.harness.readers import span_ms

        def read(ctx):
            return span_ms(ctx, "mm")
    ''',
}


def test_new_cell_from_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    for rel, body in NEW.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists()
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body))
    bench["configs"].append({"name": "toy-mlp", "source": "a test",
                             "file": "benchmark/configs/toy-mlp.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-mlp",
                               "traffic": "toy-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy-cell"]})
    bench["per_layer"].append({"name": "mm_ms.toy", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "toy", "moves": "rows_per_s",
                               "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(tmp_path)!r})
        from benchmark.harness.core import run_cell
        for trace in (False, True):
            r = run_cell("toy-cell", 3, 0.05, trace,
                         t_start=time.perf_counter(), device="cpu")
            print(json.dumps(r))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"rows_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"mm_ms.toy"}
    for rel, body in before.items():
        assert (tmp_path / rel).read_bytes() == body, rel
