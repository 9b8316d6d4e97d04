"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness.core import BENCH, FORBIDDEN, PROGRAM, ROOT


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert PROGRAM not in tops and not tops & FORBIDDEN
    assert tops <= {"torch", "numpy", "math", "contextlib", "__future__",
                    "benchmark"}, tops


def test_a_rehearsal_loads_no_forbidden_module():
    """A whole CPU rehearsal in a fresh process leaves no JAX module (by
    top-level name) in ``sys.modules``."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from benchmark.harness.core import run_cell, forbidden_modules\n"
        "import bench_toy\n"
        "s, t = bench_toy.overrides('cifar10-ni10-b64')\n"
        "r = run_cell('cifar10-ni10-b64', 5, 0.1, False, "
        "t_start=time.perf_counter(), device='cpu', spec_override=s, "
        "traffic_override=t)\n"
        "assert r['correct'], r\n"
        "print('FORBIDDEN', forbidden_modules())\n"
        % (str(ROOT), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
