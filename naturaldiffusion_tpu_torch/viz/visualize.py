"""Interactive coefficient-matrix visualizer: one offline HTML file (port
of ``naturaldiffusion_tpu/viz/visualize.py``).

Selectors for algorithm, step count, matrix kind (pred-x0 or noise
weights) and row normalisation, a colour-mapped matrix table, and the
ideal against the equivalent marginals, in plain JavaScript and a canvas:
no dependency, works offline.  ``generate_coeff_matrix_html`` derives
every registered algorithm at its reference-shipped step grids through the
port's own ``coeffs.registry`` and writes one self-contained page, the
same bytes as the JAX package's for the same derivations.  Host numpy
only: there is no card path.

    python -m naturaldiffusion_tpu_torch.viz.visualize [OUT.html]
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..coeffs import registry

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Coefficient Matrix Visualizer</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 16px; }}
 select, label {{ margin-right: 12px; font-size: 14px; }}
 table {{ border-collapse: collapse; font-size: 10px; margin-top: 10px; }}
 td, th {{ border: 1px solid #ccc; padding: 2px 4px; text-align: right;
          min-width: 42px; }}
 th {{ background: #f0f0f0; }}
 #plot {{ border: 1px solid #ccc; margin-top: 14px; }}
 .controls {{ margin-bottom: 8px; }}
</style></head><body>
<h2>Natural Inference — Coefficient Matrix Visualizer</h2>
<div class="controls">
 <label>algorithm <select id="alg"></select></label>
 <label>rows <select id="step"></select></label>
 <label>matrix <select id="kind">
   <option value="x0">pred_x0 weights</option>
   <option value="eps">noise weights</option></select></label>
 <label><input type="checkbox" id="norm"> row-normalize</label>
</div>
<canvas id="plot" width="760" height="300"></canvas>
<div id="tbl"></div>
<script>
const DATA = {data_json};
const alg = document.getElementById('alg'),
      step = document.getElementById('step'),
      kind = document.getElementById('kind'),
      norm = document.getElementById('norm');
for (const a of Object.keys(DATA)) alg.add(new Option(a, a));
function refreshSteps() {{
  step.innerHTML = '';
  for (const s of Object.keys(DATA[alg.value])) step.add(new Option(s, s));
}}
function colormap(v, vmax) {{
  if (!isFinite(v) || vmax === 0) return '#ffffff';
  const t = Math.max(-1, Math.min(1, v / vmax));
  if (t >= 0) {{ const g = Math.round(255 * (1 - t));
    return `rgb(255,${{g}},${{g}})`; }}
  const g = Math.round(255 * (1 + t));
  return `rgb(${{g}},${{g}},255)`;
}}
function render() {{
  const d = DATA[alg.value][step.value];
  let m = (kind.value === 'x0') ? d.x0 : d.eps;
  const nodes = d.node;
  if (norm.checked) m = m.map((row) => {{
    const s = row.reduce((a, b) => a + b, 0) || 1;
    return row.map((v) => v / s); }});
  let vmax = 0;
  for (const r of m) for (const v of r) vmax = Math.max(vmax, Math.abs(v));
  let html = '<table><tr><th></th>';
  const ncol = m[0].length;
  for (let j = 0; j < ncol; j++)
    html += `<th>${{(kind.value === 'x0' ? nodes[j][0]
                     : (j ? nodes[j][0] : 'init')).toFixed ?
                    Number(kind.value === 'x0' ? nodes[j][0]
                     : (j ? nodes[j][0] : nodes[0][0])).toFixed(3) : ''}}</th>`;
  html += '<th>sum</th></tr>';
  m.forEach((row, i) => {{
    html += `<tr><th>${{Number(nodes[i + 1][0]).toFixed(3)}}</th>`;
    let s = 0;
    for (const v of row) {{ s += v;
      html += `<td style="background:${{colormap(v, vmax)}}">` +
              `${{v.toFixed(3)}}</td>`; }}
    html += `<td><b>${{s.toFixed(3)}}</b></td></tr>`;
  }});
  html += '</table>';
  document.getElementById('tbl').innerHTML = html;
  drawPlot(d);
}}
function drawPlot(d) {{
  const cv = document.getElementById('plot'), ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  const n = d.x0.length;
  const ideal_sig = d.node.slice(1).map((r) => r[1]);
  const ideal_noi = d.node.slice(1).map((r) => r[2]);
  const equiv_sig = d.x0.map((r) => r.reduce((a, b) => a + b, 0));
  const equiv_noi = d.eps.map((r) =>
    Math.sqrt(r.reduce((a, b) => a + b * b, 0)));
  const X = (i) => 40 + (i / Math.max(n - 1, 1)) * (cv.width - 60);
  const Y = (v) => cv.height - 24 - v * (cv.height - 48);
  function line(vals, color, dash) {{
    ctx.strokeStyle = color; ctx.setLineDash(dash ? [6, 4] : []);
    ctx.beginPath();
    vals.forEach((v, i) => i ? ctx.lineTo(X(i), Y(v))
                             : ctx.moveTo(X(i), Y(v)));
    ctx.stroke(); ctx.setLineDash([]);
  }}
  ctx.strokeStyle = '#888';
  ctx.strokeRect(40, 24, cv.width - 60, cv.height - 48);
  line(ideal_sig, '#d62728'); line(equiv_sig, '#d62728', true);
  line(ideal_noi, '#1f77b4'); line(equiv_noi, '#1f77b4', true);
  ctx.fillStyle = '#000'; ctx.font = '12px sans-serif';
  ctx.fillText('signal: ideal (solid) vs equivalent (dashed) — red; ' +
               'noise — blue', 44, 16);
}}
alg.onchange = () => {{ refreshSteps(); render(); }};
step.onchange = render; kind.onchange = render; norm.onchange = render;
refreshSteps(); render();
</script></body></html>
"""


def matrix_to_dict(m) -> dict:
    return {"x0": np.round(m.x0, 6).tolist(),
            "eps": np.round(m.eps, 6).tolist(),
            "node": np.round(m.node, 6).tolist()}


def generate_coeff_matrix_html(path: str, algs=None, max_rows: int = 48,
                               step_counts=None) -> str:
    """Derive the matrices and write one self-contained HTML file.

    ``algs``: registry names (default every one); ``step_counts``: the
    grids to derive (default each algorithm's shipped grids whose matrix
    has at most ``max_rows`` rows, which bounds the page's size)."""
    data: dict = {}
    for alg in (algs or sorted(registry.DERIVERS)):
        spec = registry.DERIVERS[alg]
        grids = step_counts or [s for s in spec.step_counts
                                if s * spec.rows_per_step <= max_rows]
        entry = {}
        for n in grids:
            m = spec.fn(n)
            entry[str(m.num_step)] = matrix_to_dict(m)
        if entry:
            data[alg] = entry

    html = _PAGE.format(data_json=json.dumps(data))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "VisualizeCoeffMatrix.html"
    print(generate_coeff_matrix_html(out))
