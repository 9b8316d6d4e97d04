"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import json
import re

import pytest

from benchmark.harness.core import BENCH, ROOT, cell_metrics, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expansion", "experts_per_tok", "d_model", "d_kv", "d_ff")


@pytest.fixture(scope="module")
def bench():
    return read_json(ROOT / "BENCHMARK.json")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
            for key in ("why", "layer", "source"):
                if key in item and group in ("configs", "workloads"):
                    assert 1 <= len(item[key]) <= 200, item[key]
                    assert "\n" not in item[key] and "\t" not in item[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got)), group
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        spec = read_json(ROOT / c["file"])
        assert spec["name"] == c["name"]
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
        assert (BENCH / "counts" / f"{c['name']}.py").is_file()
        for key in c["reduced"]:
            assert not any(w in key for w in WIDTH_WORDS), key
            assert not key.endswith(("_dim", "_rank")), key


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = read_json(BENCH / "workloads" / f"{w['traffic']}.json")
        assert "limits" in traffic and "check_answers" in traffic
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in cell_metrics(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell_metrics(bench, w["name"], True), w["name"]


def test_time_budget(bench):
    """A full check at 24 cells fits the driver's 43,200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_json_files_parse():
    for path in BENCH.rglob("*.json"):
        json.loads(path.read_text())
