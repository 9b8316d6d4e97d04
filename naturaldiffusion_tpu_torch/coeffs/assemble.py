"""Shared matrix-assembly step for all coefficient derivers.

Copy of ``naturaldiffusion_tpu/coeffs/assemble.py``.  Every deriver follows
the reference's three-phase shape (see e.g.
``src/AnalyzeDDPMDDIM.py:177-247``): schedule math -> affine sampler replay
-> per-node coefficient extraction.  This module implements the third phase
once: walk the time nodes in descending order, read each state's coefficient
row over the ordered y/eps symbol lists, and pack the ``CoeffMatrix``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..affine import AffineTracker
from .matrix import CoeffMatrix


@dataclasses.dataclass(frozen=True)
class Node:
    """One time node: value, pool key, and ideal marginal (alpha, sigma)."""
    t: float
    key: str
    alpha: float
    sigma: float


def assemble(tracker: AffineTracker, nodes: list[Node]) -> CoeffMatrix:
    """Extract the (x0, eps, node) triple from a replayed sampler.

    ``nodes`` must be ordered from the starting node (pure noise) to the final
    node; row ``k-1`` of the matrices holds the coefficients of the state at
    node ``k`` (the reference's ``kk-1`` convention, e.g.
    ``src/AnalyzeDDPMDDIM.py:238-240``).
    """
    n = len(nodes) - 1
    y_names, eps_names = tracker.y_names, tracker.eps_names
    assert len(y_names) == n, (len(y_names), n)
    assert len(eps_names) == n + 1, (len(eps_names), n)

    x0 = np.zeros((n, n))
    eps = np.zeros((n, n + 1))
    node = np.zeros((n + 1, 3))

    for k, nd in enumerate(nodes):
        node[k] = (nd.t, nd.alpha, nd.sigma)
        if k == 0:
            continue
        state = tracker.get_item(f"x_{nd.key}")
        x0[k - 1] = tracker.coeff_row(state, y_names)
        eps[k - 1] = tracker.coeff_row(state, eps_names)

    return CoeffMatrix(x0=x0, eps=eps, node=node)
