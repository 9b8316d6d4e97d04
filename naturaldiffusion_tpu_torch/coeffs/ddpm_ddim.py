"""DDPM-ancestral and DDIM coefficient matrices.

Copy of ``naturaldiffusion_tpu/coeffs/ddpm_ddim.py`` (numpy only), kept here so the
port never imports the JAX package.

Two independent derivations, cross-checking each other exactly as the
reference does (``src/AnalyzeDDPMDDIM.py:446-453``):

* ``derive_ddpm`` / ``derive_ddim`` — affine replay of the sampler recursion
  (replaces the reference SymPy path ``ddpm_sympy_analyze_coeff``,
  ``src/AnalyzeDDPMDDIM.py:177-247`` and ``ddim_sympy_analyze_coeff:343-405``).
  Regression oracle: ``results/ddpm/ddpm_sympy_*.npz``,
  ``results/ddim/ddim_sympy_*.npz``.

* ``derive_ddpm_analytic`` / ``derive_ddim_analytic`` — closed-form product
  recursion (reference ``ddpm_analyze_coeff:126-174`` /
  ``ddim_analyze_coeff:297-340``).  Regression oracle:
  ``results/ddpm/ddpm_*.npz``, ``results/ddim/ddim_*.npz``.  (These store a
  slightly different ``node`` first row — the analytic path hard-codes
  ``[999, 0, 1]`` while the affine path records the true marginal at t=999.)
"""

from __future__ import annotations

import numpy as np

from ..affine import AffineTracker
from ..schedules import DiscreteVP
from .assemble import Node, assemble
from .matrix import CoeffMatrix


def _int_key(t: int) -> str:
    return "%03d" % t


def _discrete_nodes(sch: DiscreteVP) -> list[Node]:
    """Descending node list with the terminal clean node t=-1 appended
    (the reference's 'denoise to zero' node, ``src/AnalyzeDDPMDDIM.py:186-191``)."""
    ts = list(sch.timesteps[::-1]) + [-1]
    ab = np.append(sch.alphas_bar[::-1], 1.0)
    return [Node(t=float(t), key=_int_key(int(t)),
                 alpha=float(np.sqrt(ab[k])), sigma=float(np.sqrt(1.0 - ab[k])))
            for k, t in enumerate(ts)]


def derive_ddpm(num_step: int) -> CoeffMatrix:
    """DDPM ancestral sampling as a coefficient matrix (affine replay)."""
    sch = DiscreteVP.create(num_step)
    nodes = _discrete_nodes(sch)

    # per-step coefficients walked in reverse (descending) time order
    c_xt = sch.ddpm_coeff_xt[::-1]
    c_x0 = sch.ddpm_coeff_x0[::-1]
    std = sch.posterior_std[::-1]

    tr = AffineTracker()
    tr.add_item(f"x_{nodes[0].key}", tr.new_eps(nodes[0].key))

    for i in range(num_step):
        s, t = nodes[i], nodes[i + 1]
        x_s = tr.get_item(f"x_{s.key}")
        y_s = tr.new_y(s.key)
        # posterior mean, then ancestral noise injection
        mean = c_xt[i] * x_s + c_x0[i] * y_s
        x_t = mean + std[i] * tr.new_eps(t.key)
        tr.add_item(f"x_{t.key}", x_t)

    return assemble(tr, nodes)


def derive_ddim(num_step: int) -> CoeffMatrix:
    """DDIM (eta=0) as a coefficient matrix (affine replay)."""
    sch = DiscreteVP.create(num_step)
    nodes = _discrete_nodes(sch)

    c_xt = sch.ddim_coeff_xt[::-1]
    c_x0 = sch.ddim_coeff_x0[::-1]

    tr = AffineTracker()
    tr.add_item(f"x_{nodes[0].key}", tr.new_eps(nodes[0].key))

    for i in range(num_step):
        s, t = nodes[i], nodes[i + 1]
        x_s = tr.get_item(f"x_{s.key}")
        y_s = tr.new_y(s.key)
        x_t = c_xt[i] * x_s + c_x0[i] * y_s
        tr.add_item(f"x_{t.key}", x_t)

    # deterministic: eps symbols exist only for the initial noise; pad the
    # symbol list so assemble sees n+1 columns (all-zero beyond column 0)
    for nd in nodes[1:]:
        tr.new_eps(nd.key)

    return assemble(tr, nodes)


# ---------------------------------------------------------------------------
# Closed-form cross-checks (product recursion, no tracker)
# ---------------------------------------------------------------------------


def _analytic_node_tail(sch: DiscreteVP, num_step: int) -> np.ndarray:
    """node rows for the analytic path: hard-coded start row [999, 0, 1] then
    per-row true marginals (reference ``src/AnalyzeDDPMDDIM.py:154-167``)."""
    node = np.zeros((num_step + 1, 3))
    node[0] = (999.0, 0.0, 1.0)
    for start in range(1, num_step):
        k = num_step - start
        ab = sch.alphas_bar[start - 1]
        node[k] = (float(sch.timesteps[start - 1]), np.sqrt(ab), np.sqrt(1.0 - ab))
    # final 'denoise to zero' row
    node[num_step] = (-1.0, 1.0, 0.0)
    return node


def derive_ddpm_analytic(num_step: int) -> CoeffMatrix:
    sch = DiscreteVP.create(num_step)
    c_xt, c_x0, std = sch.ddpm_coeff_xt, sch.ddpm_coeff_x0, sch.posterior_std

    x0 = np.zeros((num_step, num_step))
    eps = np.zeros((num_step, num_step + 1))
    end = num_step
    for start in range(end):
        row = end - start - 1
        # initial-noise column, then injected noises newest-step-first
        es = [np.prod(c_xt[start:end])]
        es += [std[i] * np.prod(c_xt[start:i]) for i in range(end - 1, start - 1, -1)]
        eps[row, : 1 + end - start] = es
        xs = [c_x0[i] * np.prod(c_xt[start:i]) for i in range(end - 1, start - 1, -1)]
        x0[row, : end - start] = xs

    return CoeffMatrix(x0=x0, eps=eps, node=_analytic_node_tail(sch, num_step))


def derive_ddim_analytic(num_step: int) -> CoeffMatrix:
    sch = DiscreteVP.create(num_step)
    c_xt, c_x0 = sch.ddim_coeff_xt, sch.ddim_coeff_x0

    x0 = np.zeros((num_step, num_step))
    eps = np.zeros((num_step, num_step + 1))
    end = num_step
    for start in range(end):
        row = end - start - 1
        eps[row, 0] = np.prod(c_xt[start:end])
        xs = [c_x0[i] * np.prod(c_xt[start:i]) for i in range(end - 1, start - 1, -1)]
        x0[row, : end - start] = xs

    return CoeffMatrix(x0=x0, eps=eps, node=_analytic_node_tail(sch, num_step))
