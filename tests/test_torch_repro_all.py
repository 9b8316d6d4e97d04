"""The port's reproduction driver (``apps.repro_all``): its steps are the
JAX driver's, by name and count, with and without ``--chip``; every child
runs a module of the port (never the JAX package or ``bench.py``), the
CPU steps with ``--device cpu`` where the app takes it; and a step runs to
its end in a child that imports no JAX, with the JAX driver's log,
summary and exit code."""

import json
import subprocess
import sys

import pytest

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.apps import repro_all as jr
from naturaldiffusion_tpu_torch.apps import repro_all as pr

# the port apps among the CPU steps that take ``--device``
DEVICE_APPS = ("apps.validate", "apps.validate_dit", "apps.fid_selfcheck")


def _module(cmd):
    assert cmd[:2] == [sys.executable, "-m"], cmd
    return cmd[2]


@pytest.mark.parametrize("chip", [False, True])
def test_steps_are_jax_steps(chip):
    got = pr._steps("/tmp/x", chip=chip, quick=False)
    want = jr._steps("/tmp/x", chip=chip, quick=False)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == (9 if chip else 5)
    for name, cmd in got:
        assert all(isinstance(c, str) for c in cmd)
        assert _module(cmd).startswith("naturaldiffusion_tpu_torch."), name
        assert not any("naturaldiffusion_tpu." in c or c.endswith(
            "bench.py") for c in cmd), (name, cmd)


def test_cpu_steps_carry_device_cpu():
    steps = dict(pr._steps("/tmp/x", chip=False, quick=False))
    for name, cmd in steps.items():
        mod = _module(cmd).removeprefix("naturaldiffusion_tpu_torch.")
        takes = mod in DEVICE_APPS
        assert (cmd[-2:] == ["--device", "cpu"]) == takes, (name, cmd)
    chip = dict(pr._steps("/tmp/x", chip=True, quick=False))
    assert _module(chip["bench_headline"]) == \
        "naturaldiffusion_tpu_torch.apps.bench"
    for name in ("bench_headline", "bench_quant_ops", "quant_accuracy",
                 "sweep_cell"):
        assert "--device" not in chip[name], name


def test_step_arguments_follow_jax():
    """Each step passes the JAX step's arguments (JAX's ``_cpu_mod``
    wrapper aside), plus ``--device cpu`` on the CPU steps."""
    got = dict(pr._steps("out", chip=True, quick=False))
    for name, cmd in jr._steps("out", chip=True, quick=False):
        if cmd[1] == "-c":          # _cpu_mod: the argv is in the code
            args = eval(cmd[2].split("sys.argv = ")[1].split("\n")[0])[1:]
        elif name == "bench_headline":
            args = []
        else:
            args = cmd[3:]
        mine = [a for a in got[name][3:] if a not in ("--device", "cpu")]
        assert mine == args, name


def test_visualize_step_runs_to_its_end_without_jax(tmp_path, monkeypatch):
    steps = [s for s in pr._steps(str(tmp_path), chip=False, quick=False)
             if s[0] == "visualize"]
    # the child's own import list: no JAX, nothing of the JAX package
    name, cmd = steps[0]
    probe = subprocess.run([cmd[0], "-X", "importtime"] + cmd[1:],
                           capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0, probe.stderr[-2000:]
    mods = [ln.split("|")[-1].strip() for ln in probe.stderr.splitlines()
            if ln.startswith("import time:")]
    assert "naturaldiffusion_tpu_torch.coeffs.registry" in mods
    assert not [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "naturaldiffusion_tpu")]
    monkeypatch.setattr(pr, "_steps", lambda out, chip, quick: steps)
    assert pr.main(["--out", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "repro_summary.json").read_text())
    assert [(r["step"], r["rc"]) for r in rows] == [("visualize", 0)]
    page = tmp_path / "corpus" / "VisualizeCoeffMatrix.html"
    assert page.read_text().startswith("<!DOCTYPE html>")
    assert (tmp_path / "logs" / "visualize.log").read_text().strip() == \
        str(page)


def test_exit_code_counts_failed_steps(tmp_path, monkeypatch):
    fail = [sys.executable, "-c", "raise SystemExit(3)"]
    monkeypatch.setattr(pr, "_steps", lambda out, chip, quick: [
        ("a", fail), ("b", [sys.executable, "-c", "pass"]), ("c", fail)])
    assert pr.main(["--out", str(tmp_path)]) == 2
    rows = json.loads((tmp_path / "repro_summary.json").read_text())
    assert [r["rc"] for r in rows] == [3, 0, 3]
