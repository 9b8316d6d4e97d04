"""The port's coefficient-matrix visualizer (``viz.visualize``) writes the
same page as the JAX package's, byte for byte, over the port's own
registry: at the defaults (every derivation at its shipped grids of at
most 48 rows) and for chosen algorithms, row bounds and step counts,
one- and multi-row methods among them."""

import json
import os
import subprocess
import sys

import pytest

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.viz import visualize as jviz
from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.viz import visualize as pviz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pages(tmp_path, **kw):
    j = jviz.generate_coeff_matrix_html(str(tmp_path / "j.html"), **kw)
    p = pviz.generate_coeff_matrix_html(str(tmp_path / "p" / "p.html"), **kw)
    return open(j, "rb").read(), open(p, "rb").read()


def page_data(html: bytes):
    line = next(ln for ln in html.decode().splitlines()
                if ln.startswith("const DATA = "))
    return json.loads(line[len("const DATA = "):-1])


@pytest.mark.parametrize("kw", [
    {},
    dict(algs=["ddim", "flow_euler", "dpmsolver2s"]),
    dict(algs=["ddim", "flow_euler", "ode_heun", "dpmsolverpp3s"],
         max_rows=200),
    dict(algs=["ddim", "flow_euler", "dpmsolver2s", "deis_tab"],
         step_counts=[3, 7]),
], ids=["defaults", "three", "max_rows_200", "step_counts"])
def test_page_equals_jax_byte_for_byte(tmp_path, kw):
    want, got = pages(tmp_path, **kw)
    data = page_data(got)
    algs = kw.get("algs") or sorted(registry.DERIVERS)
    assert list(data) == [a for a in algs if a in data] and data
    if "step_counts" in kw:
        # a two-row method's matrix has twice the rows of its step count
        assert len(data["dpmsolver2s"]["6"]["x0"]) == 6
    assert got == want


def test_matrix_to_dict_rounds_as_jax():
    m = registry.derive("dpmsolverpp2s", 9)
    assert pviz.matrix_to_dict(m) == jviz.matrix_to_dict(m)


def test_cli_writes_the_page(tmp_path):
    out = tmp_path / "sub" / "VisualizeCoeffMatrix.html"
    r = subprocess.run([sys.executable, "-m",
                        "naturaldiffusion_tpu_torch.viz.visualize", str(out)],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(out)
    want = jviz.generate_coeff_matrix_html(str(tmp_path / "j.html"))
    assert out.read_bytes() == open(want, "rb").read()
