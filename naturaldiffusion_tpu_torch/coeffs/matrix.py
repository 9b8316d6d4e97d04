"""CoeffMatrix — the single interchange format of the framework.

Copy of ``naturaldiffusion_tpu/coeffs/matrix.py`` (numpy only), kept here so
the port never imports the JAX package.

The reference's analysis and execution halves communicate exclusively through
an npz triple ``(past_xstart_coeff, past_epsilon_coeff, node_coeff)``
(written at ``src/Utils.py:49``, loaded at ``src/CIFAR10NaturalInference.py:273``
and ``src/ValidateNaturalInference.py:319``).  ``CoeffMatrix`` is that triple
as a frozen dataclass:

* ``x0`` — ``[n, n]`` lower-triangular weights over past predicted x0's
* ``eps`` — ``[n, n+1]`` weights over initial + injected noises (column 0 is
  the initial noise; deterministic samplers have only column 0 non-zero)
* ``node`` — ``[n+1, 3]`` per time node ``[t, ideal alpha_t, ideal sigma_t]``

Invariant (the "natural" property): row-sums of ``x0`` track alpha_t and row
L2 norms of ``eps`` track sigma_t (checked in the reference at every
derivation site, e.g. ``src/AnalyzeDDPMDDIM.py:226-234``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoeffMatrix:
    x0: np.ndarray     # [n, n]
    eps: np.ndarray    # [n, n+1]
    node: np.ndarray   # [n+1, 3]: (t, alpha_t, sigma_t)

    def __post_init__(self):
        n = self.x0.shape[0]
        assert self.x0.shape == (n, n), self.x0.shape
        assert self.eps.shape == (n, n + 1), self.eps.shape
        assert self.node.shape == (n + 1, 3), self.node.shape

    @property
    def num_step(self) -> int:
        return self.x0.shape[0]

    @property
    def is_deterministic(self) -> bool:
        """True if noise is only injected at the start (e.g. DDIM, ODE)."""
        return bool(np.all(self.eps[:, 1:] == 0.0))

    def marginal_errors(self) -> tuple[np.ndarray, np.ndarray]:
        """(|row-sum(x0) - alpha|, |row-norm(eps) - sigma|) per step."""
        sig_err = np.abs(self.x0.sum(axis=1) - self.node[1:, 1])
        noi_err = np.abs(np.linalg.norm(self.eps, axis=1) - self.node[1:, 2])
        return sig_err, noi_err

    def check_finite(self, context: str = "") -> "CoeffMatrix":
        """NaN guard (SURVEY §5 sanitizer row): the coefficient derivers run
        log/sqrt/arccos chains in fp64 where a silently poisoned schedule
        (e.g. negative beta, sigma=0) would emit NaN matrices and corrupt
        everything downstream.  Raises instead."""
        for name, arr in (("x0", self.x0), ("eps", self.eps),
                          ("node", self.node)):
            bad = ~np.isfinite(arr)
            if bad.any():
                idx = tuple(int(i[0]) for i in np.nonzero(bad))
                raise FloatingPointError(
                    f"non-finite coefficient in {context or 'CoeffMatrix'}."
                    f"{name} at {idx} (value {arr[idx]!r})")
        return self

    # -- io -----------------------------------------------------------------

    def save(self, path: str) -> None:
        """The reference's npz triple (``src/Utils.py:49``)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, past_xstart_coeff=self.x0,
                 past_epsilon_coeff=self.eps, node_coeff=self.node)

    @classmethod
    def load(cls, path: str) -> "CoeffMatrix":
        with np.load(path) as f:
            x0 = f["past_xstart_coeff"]
            eps = f["past_epsilon_coeff"]
            node = f["node_coeff"]
        if eps.shape[1] == eps.shape[0]:
            # the learned weight matrices (weights/step_*_weight_*.npz) store
            # eps as [n, n] — deterministic, only column 0 (initial noise)
            # populated; pad the trailing injected-noise column
            eps = np.concatenate([eps, np.zeros((eps.shape[0], 1))], axis=1)
        return cls(x0=x0, eps=eps, node=node)

    def save_csv(self, path: str) -> None:
        """Human-readable CSV mirror (the layout of ``src/Utils.py:36-45``):
        the x0 matrix rounded to 3 decimals with node-time row and column
        labels and a trailing row-sum column."""
        n = self.num_step
        if self.node[:, 0].mean() > 1:
            names = ["%03d" % t for t in self.node[:, 0]]
        else:
            names = ["%0.3f" % t for t in self.node[:, 0]]
        lines = ["," + ",".join(names[:-1]) + ",sum"]
        sums = self.x0.sum(axis=1)
        for i in range(n):
            row = ",".join("%g" % v for v in self.x0[i].round(3))
            lines.append(f"{names[i + 1]},{row},{sums[i].round(3):g}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
