"""Rectified-flow (flow-matching) Euler coefficient matrices.

Copy of ``naturaldiffusion_tpu/coeffs/flow.py`` (numpy only), kept here so the
port never imports the JAX package.

For flow matching the Natural-Inference equivalence is *exact*: the Euler
update ``x_t = x_s + (x_s - y_s)/s * (t - s)`` telescopes into weights whose
row-sum equals ``1 - sigma`` and whose initial-noise weight equals ``sigma``
identically (reference key result, ``src/AnalyzeFlowMatching.py:96-104``).

* ``derive_flow_euler`` — affine replay (reference ``flow_simpy_analyze_coeff``,
  ``src/AnalyzeFlowMatching.py:62-115``; oracle
  ``results/flow_euler/flow_euler_simpy_*.npz``).
* ``derive_flow_euler_analytic`` — closed-form product recursion (reference
  ``flow_analyze_coeff:20-59``; oracle ``results/flow_euler/flow_euler_018.npz``).
"""

from __future__ import annotations

import numpy as np

from ..affine import AffineTracker
from ..schedules import flow_sigmas
from .assemble import Node, assemble
from .matrix import CoeffMatrix

_KEY = "%0.4f"


def derive_flow_euler(num_step: int) -> CoeffMatrix:
    ts = flow_sigmas(num_step)[::-1]  # descending 1 -> 0

    tr = AffineTracker()
    tr.add_item(f"x_{_KEY % ts[0]}", tr.new_eps(_KEY % ts[0]))

    for i in range(num_step):
        s, t = ts[i], ts[i + 1]
        x_s = tr.get_item(f"x_{_KEY % s}")
        y_s = tr.new_y(_KEY % s)
        velocity = (x_s - y_s) / s
        tr.add_item(f"x_{_KEY % t}", x_s + velocity * (t - s))
        tr.new_eps(_KEY % t)  # deterministic pad

    nodes = [Node(t=float(t), key=_KEY % t, alpha=float(1.0 - t), sigma=float(t))
             for t in ts]
    return assemble(tr, nodes)


def derive_flow_euler_analytic(num_step: int) -> CoeffMatrix:
    sigmas = flow_sigmas(num_step)
    c_x0 = 1.0 - sigmas[:-1] / sigmas[1:]
    c_xt = sigmas[:-1] / sigmas[1:]

    x0 = np.zeros((num_step, num_step))
    eps = np.zeros((num_step, num_step + 1))
    node = np.zeros((num_step + 1, 3))
    node[0] = (1.0, 0.0, 1.0)

    end = num_step
    for start in range(end):
        row = end - start - 1
        eps[row, 0] = np.prod(c_xt[start:end])
        xs = [c_x0[i] * np.prod(c_xt[start:i]) for i in range(end - 1, start - 1, -1)]
        x0[row, : end - start] = xs
        node[row + 1] = (sigmas[start], 1.0 - sigmas[start], sigmas[start])

    return CoeffMatrix(x0=x0, eps=eps, node=node)
