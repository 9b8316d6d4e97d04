"""DDPM-ancestral and DDIM coefficient matrices (affine replay).

The two derivations of ``naturaldiffusion_tpu/coeffs/ddpm_ddim.py`` that the
port's first slice needs, copied so the port never imports the JAX package
(reference: ``ddpm_sympy_analyze_coeff``, ``src/AnalyzeDDPMDDIM.py:177-247``,
and ``ddim_sympy_analyze_coeff:343-405``).  The closed-form cross-checks
stay in the JAX package; the port's tests hold these matrices against it.
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
