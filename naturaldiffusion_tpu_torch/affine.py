"""Exact affine-coefficient propagation (numpy, float64).

Copy of ``naturaldiffusion_tpu/affine.py``: the port keeps its own copy so it
never imports the JAX package.  Every sampler update is affine in the basis
symbols (the predicted-x0 outputs ``y_t`` and the injected noises ``eps_t``),
so a sparse coefficient vector per state, propagated with float64
arithmetic, yields the Natural-Inference coefficient matrices exactly.

``AffineTracker`` mirrors the reference ``CAnalyzer`` contract (add_item /
get_item / ordered y- and eps-symbol lists / coefficient extraction) so each
deriver in :mod:`naturaldiffusion_tpu_torch.coeffs` follows the reference
sampler's update recursion and emits bit-comparable matrices.
"""

from __future__ import annotations

import numpy as np


class Affine:
    """A sparse affine expression ``sum_i c_i * sym_i`` over named symbols.

    Supports +, -, unary -, scalar *, scalar /.  Scalars are coerced to
    float64.  Symbols are interned strings; ``terms`` maps name -> float.
    """

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms) if terms else {}

    @classmethod
    def symbol(cls, name: str) -> "Affine":
        return cls({name: 1.0})

    @classmethod
    def zero(cls) -> "Affine":
        return cls()

    def coeff(self, name: str) -> float:
        return self.terms.get(name, 0.0)

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, Affine):
            out = dict(self.terms)
            for k, v in other.terms.items():
                out[k] = out.get(k, 0.0) + v
            return Affine(out)
        if _is_scalar(other):
            if float(other) != 0.0:
                raise ValueError("cannot add a nonzero constant to an Affine "
                                 "expression (states must stay affine in the "
                                 "symbol basis with no constant offset)")
            return Affine(self.terms)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return Affine({k: -v for k, v in self.terms.items()})

    def __mul__(self, other):
        if _is_scalar(other):
            s = float(other)
            return Affine({k: v * s for k, v in self.terms.items()})
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if _is_scalar(other):
            s = float(other)
            return Affine({k: v / s for k, v in self.terms.items()})
        return NotImplemented

    def __repr__(self):
        body = " + ".join(f"{v:.6g}*{k}" for k, v in self.terms.items())
        return f"Affine({body or '0'})"


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float, np.floating, np.integer)) or (
        isinstance(x, np.ndarray) and x.ndim == 0
    )


class AffineTracker:
    """Expression pool mirroring the reference ``CAnalyzer``.

    Keys follow the reference convention: ``x_<key>`` for states,
    ``y_<key>`` for predicted-x0 symbols, ``eps_<key>`` for noise symbols —
    where ``<key>`` is the formatted time-node string (e.g. ``"%0.4f" % t`` or
    ``"%03d" % t``).  Symbol order (and hence matrix column order) is the
    insertion order, exactly as the reference's dict-backed pool.
    """

    def __init__(self):
        self._pool: dict[str, Affine] = {}
        self._y_names: list[str] = []
        self._eps_names: list[str] = []

    # -- pool ---------------------------------------------------------------

    def add_item(self, key: str, val: Affine) -> None:
        assert key not in self._pool, f"duplicate key {key!r}"
        assert isinstance(val, Affine)
        self._pool[key] = val
        if key.startswith("y_") and val.terms == {key: 1.0}:
            self._y_names.append(key)
        elif key.startswith("eps_") and val.terms == {key: 1.0}:
            self._eps_names.append(key)

    def get_item(self, key: str) -> Affine:
        assert key in self._pool, f"missing key {key!r}"
        return self._pool[key]

    def __contains__(self, key: str) -> bool:
        return key in self._pool

    # -- symbol factories ---------------------------------------------------

    def new_y(self, key: str) -> Affine:
        """Create+register the predicted-x0 symbol ``y_<key>``."""
        name = f"y_{key}"
        sym = Affine.symbol(name)
        self.add_item(name, sym)
        return sym

    def new_eps(self, key: str) -> Affine:
        """Create+register the injected-noise symbol ``eps_<key>``."""
        name = f"eps_{key}"
        sym = Affine.symbol(name)
        self.add_item(name, sym)
        return sym

    # -- extraction ---------------------------------------------------------

    @property
    def y_names(self) -> list[str]:
        return list(self._y_names)

    @property
    def eps_names(self) -> list[str]:
        return list(self._eps_names)

    def coeff_row(self, expr: Affine, names: list[str]) -> np.ndarray:
        return np.array([expr.coeff(n) for n in names], dtype=np.float64)
