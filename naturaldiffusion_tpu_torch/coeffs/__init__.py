"""Coefficient matrices: every sampler as data for the NI engine."""

from .matrix import CoeffMatrix
from .registry import DERIVERS, derive

__all__ = ["CoeffMatrix", "DERIVERS", "derive"]
