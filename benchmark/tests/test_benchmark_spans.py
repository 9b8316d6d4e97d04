"""The per-layer metrics that read the program's spans
(``harness/spans.py`` and the five ``metrics/*.py`` over it): each reader on
a synthetic span record and a synthetic traced stretch, and a CPU rehearsal
of one SD3 and one CIFAR cell with ``--trace 1``."""

import time
from types import SimpleNamespace

import pytest

from benchmark.harness import spans
from benchmark.harness.core import BENCH, load_file, run_cell
from benchmark.harness.trace import Profile
from bench_toy import overrides

SD3_READERS = ("ni_step_ms.sd3", "mmdit_ops.sd3", "text_ms.sd3",
               "decode_ms.sd3")
NEW = SD3_READERS + ("replay_ms.cifar",)


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", "metric")


def run(host_s, device_s, parent=None, outer=1):
    return SimpleNamespace(host_s=host_s, device_s=device_s, parent=parent,
                           outer=outer)


@pytest.fixture
def record(monkeypatch):
    """A synthetic span record in the program's place."""
    rec = {
        "ni.step": [run(0.080, 0.070), run(0.081, 0.072),
                    run(0.500, 0.300), run(0.079, 0.071)],
        "mmdit.forward": [run(0.020, 0.060, "ni.step"),
                          run(0.030, 0.061, "ni.step"),
                          run(0.025, 0.062, "ni.step")],
        "sd3.encode_prompt": [run(0.090, 0.080), run(0.095, 0.084)],
        "vae.decode": [run(0.150, None)],       # a run without CUDA
    }
    monkeypatch.setattr(spans, "ON", True)
    monkeypatch.setattr(spans, "_profiling",
                        SimpleNamespace(span_record=lambda: rec))
    return rec


def test_readers_take_medians(record):
    ctx = SimpleNamespace(profile=None)
    got = {n: reader(n).read(ctx) for n in NEW}
    assert got["ni_step_ms.sd3"] == pytest.approx(71.5)
    assert got["text_ms.sd3"] == pytest.approx(82.0)
    assert got["decode_ms.sd3"] == pytest.approx(150.0)  # the host's
    assert got["mmdit_ops.sd3"] is None                  # no trace
    assert got["replay_ms.cifar"] is None                # span never ran


def test_readers_none_without_program_spans(monkeypatch):
    monkeypatch.setattr(spans, "ON", False)
    ctx = SimpleNamespace(profile=Profile(t0=0, t1=10))
    assert all(reader(n).read(ctx) is None for n in NEW)


def test_outermost_ops_inside_each_span():
    prof = Profile(
        t0=0, t1=1000,
        spans=[("request", 0, 1000), ("mmdit.forward", 100, 100),
               ("mmdit.forward", 300, 100), ("ni.step", 90, 150)],
        host_ops=[("aten::linear", 110, 20), ("aten::matmul", 112, 10),
                  ("aten::mm", 113, 5),            # nested: count once
                  ("aten::add", 140, 5), ("aten::mul", 150, 60),  # ends out
                  ("aten::cat", 50, 5),            # before the span
                  ("aten::to", 310, 5), ("aten::silu", 320, 5),
                  ("aten::view", 330, 1), ("aten::empty", 331, 1)])
    assert spans.ops_per_span(prof, "mmdit.forward") == pytest.approx(3.0)
    ctx = SimpleNamespace(profile=prof)
    assert reader("mmdit_ops.sd3").read(ctx) == pytest.approx(3.0)
    assert spans.ops_per_span(prof, "vae.decode") is None
    assert spans.ops_per_span(None, "mmdit.forward") is None


@pytest.mark.parametrize("cell", ["sd3m-512-b4", "cifar10-ni10-b64"])
def test_cell_at_toy_size_reports_the_span_metrics(cell):
    """The whole traced run on the CPU: the SD3 cell reports its four new
    metrics, and its traced stretch holds the program's spans.  The CIFAR
    cell runs no graph on the CPU, so ``replay_ms.cifar`` has nothing to
    read there and is left out (it is read on the card:
    ``test_cifar_cell_reports_replay_ms_on_the_card``)."""
    spans._profiling.clear_spans()
    spec, traffic = overrides(cell)
    r = run_cell(cell, 2 ** 31 + 13, 0.2, True, t_start=time.perf_counter(),
                 device="cpu", spec_override=spec, traffic_override=traffic)
    assert r["correct"] and r["failed"] == 0
    got = set(r["metrics"])
    if cell.startswith("sd3"):
        assert set(SD3_READERS) <= got
        assert r["metrics"]["mmdit_ops.sd3"]["value"] > 10
        assert all(r["metrics"][n]["value"] > 0 for n in SD3_READERS)
    else:
        assert "replay_ms.cifar" not in got and "mfu.cifar" in got


@pytest.mark.card
def test_cifar_cell_reports_replay_ms_on_the_card(card):
    spans._profiling.clear_spans()
    spec, traffic = overrides("cifar10-ni10-b64")
    r = run_cell("cifar10-ni10-b64", 2 ** 31 + 13, 0.5, True,
                 t_start=time.perf_counter(), spec_override=spec,
                 traffic_override=traffic)
    assert r["correct"] and r["metrics"]["replay_ms.cifar"]["value"] > 0
