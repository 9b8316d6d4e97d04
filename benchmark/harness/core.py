"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything particular is found by name under ``benchmark/``:

* ``workloads/<traffic>.json``: the traffic's parameters;
* ``configs/<config>.json``: the configuration's sizes, and
  ``configs/<config>.py``: ``make(spec, traffic, seed, device)``, the
  system under test (:class:`System`), and ``make_checker`` with the same
  arguments, its check (:class:`Checker`);
* ``counts/<config>.py``: operations and bytes from the shapes;
* ``metrics/<metric>.py``: ``read(ctx)``, one metric's number or None.

``BENCHMARK.json`` says which metrics a cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import random
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Protocol

from . import trace as tracing
from .env import CACHE, ROOT

BENCH = ROOT / "benchmark"
TRACE_FILE = CACHE / "trace" / "profile.pt.trace.json"
FORBIDDEN = {"jax", "jaxlib", "flax", "naturaldiffusion_tpu"}
PROGRAM = "naturaldiffusion_tpu_torch"
PROFILED = 1            # requests a --trace 1 run profiles after its window


class System(Protocol):
    """What a configuration's ``make`` returns."""

    def setup(self, wait_build) -> None:
        """Make the weights from the seed and warm every shape the traffic
        uses; call ``wait_build()`` before the first kernel launch."""

    def run(self, i: int, spans: dict) -> list:
        """Request ``i``: inputs from the seed and ``i``, the program's
        entry, synchronised; returns the answers (tensors), and adds the
        host seconds of its phases to ``spans``."""

    def images(self, answers: list) -> int:
        """Images the answers of one request hold."""

    def free(self) -> None:
        """Drop the program's state (models, graphs, caches)."""


class Checker(Protocol):
    """What a configuration's ``make_checker`` returns: the references,
    made from the same seed once the program's state is freed."""

    def check(self, answers: dict, keys: list) -> list:
        """``[(name, value, limit)]``: the answers at ``keys`` (``(i, j)``:
        request, answer) against the reference."""


def load_file(path: Path, tag: str):
    """The module in the file at ``path``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    name = f"_bench_{tag}_" + "".join(c if c.isalnum() else "_"
                                      for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics ``cell`` reports: with ``trace`` the per-layer ones,
    else the end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moves
                             else [])]


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def sample_keys(keys: list, seed: int, count: int) -> list:
    """``count`` of ``keys`` drawn from ``seed``, in order."""
    rng = random.Random(seed * 7919 + 17)
    return sorted(rng.sample(sorted(keys), min(count, len(keys))))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", spec_override=None,
             traffic_override=None, bench_path: Path = ROOT / "BENCHMARK.json",
             log=sys.stderr) -> dict:
    """One run; returns the result's dict (the caller prints it).
    ``device="cpu"`` and the overrides are for the CPU rehearsals."""
    import torch

    bench = read_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"{cell!r} is not a workload of {bench_path.name}")
    traffic = dict(read_json(BENCH / "workloads" / f"{entry['traffic']}.json"),
                   **(traffic_override or {}))
    cfg_name = entry["config"]
    spec = dict(read_json(BENCH / "configs" / f"{cfg_name}.json"),
                **(spec_override or {}))
    cfg = load_file(BENCH / "configs" / f"{cfg_name}.py", "config")
    counts = load_file(BENCH / "counts" / f"{cfg_name}.py", "counts")
    wanted = cell_metrics(bench, cell, trace)
    readers = {m["name"]: load_file(BENCH / "metrics" / f"{m['name']}.py",
                                    "metric") for m in wanted}

    # the program's kernels build (once per checkout) while the weights
    # are made; nothing launches a kernel before wait_build()
    build = {"seconds": 0.0, "waited_s": 0.0}
    build_err = []
    builder = None
    if device == "cuda":
        from naturaldiffusion_tpu_torch.ops import _nvcc

        def compile_all():
            try:
                build["seconds"] = max(_nvcc.build().values(), default=0.0)
            except Exception as e:          # re-raised by wait_build
                build_err.append(e)
        builder = threading.Thread(target=compile_all, daemon=True)
        builder.start()

    def wait_build():
        if builder is not None and builder.is_alive():
            t0 = time.perf_counter()
            builder.join()
            build["waited_s"] += time.perf_counter() - t0
        if build_err:
            raise build_err[0]

    system = cfg.make(spec, traffic, seed, device)
    system.setup(wait_build)
    wait_build()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"[bench] {cell}: set-up {setup_s:.3f} s, of which "
          f"{build['waited_s']:.3f} s waited for the kernels' build "
          f"({build['seconds']:.3f} s)", file=log, flush=True)

    # the measured window: a closed loop of one client, ended by the
    # request in flight at `seconds`
    answers, spans, took = {}, {}, []
    attempted = failed = images = requests = 0
    w0 = time.perf_counter()
    while True:
        r0 = time.perf_counter()
        try:
            with torch.profiler.record_function("request"):
                outs = system.run(requests, spans)
            for j, a in enumerate(outs):
                answers[(requests, j)] = a
            images += system.images(outs)
            attempted += len(outs)
        except Exception:
            traceback.print_exc(file=log)
            failed += 1
            attempted += 1
        requests += 1
        took.append(time.perf_counter() - r0)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    prof = None
    if trace:
        first = requests

        def block():
            for k in range(first, first + PROFILED):
                with torch.profiler.record_function("request"):
                    system.run(k, {})
        prof = tracing.profile(block, str(TRACE_FILE))

    ctx = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, requests=requests,
        images=images, spans=spans, profile=prof, spec=spec, traffic=traffic,
        counts=counts, seconds=seconds)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    system.free()
    del system
    if device == "cuda":
        torch.cuda.empty_cache()
    keys = sample_keys(list(answers), seed, int(traffic["check_answers"]))
    t_check = time.perf_counter()
    checks = cfg.make_checker(spec, traffic, seed, device).check(
        answers, keys) if keys else []
    del answers
    print(f"[bench] {cell}: window {window_s:.3f} s, {requests} requests "
          f"({', '.join(f'{t:.4f}' for t in took)} s), check "
          f"{time.perf_counter() - t_check:.3f} s", file=log, flush=True)
    correct = failed == 0 and bool(checks) and all(
        v == v and v <= lim for _, v, lim in checks)

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")

    dev = ({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(entry["chips"]), "memory_peak_bytes": int(mem_peak)}
           if device == "cuda" else {"platform": "cpu", "kind": "cpu",
                                     "count": 1, "memory_peak_bytes": 0})
    # a build in this run (the first of a checkout) shows apart from set-up
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, "build": build}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        result["breakdown"] = {"device_ops": prof.top_device_ops(),
                               "idle_gaps": prof.idle_gaps()}
        if device == "cuda":
            result["card"] = power_limit()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=log, flush=True)
    return result


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"the program ({PROGRAM}) is not in this checkout",
              file=sys.stderr)
        return 4
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    print(json.dumps(result), flush=True)
    return 0
