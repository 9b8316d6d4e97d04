"""The inverse data scaler (``naturaldiffusion_tpu/data/datasets.py:32``):
model space back to [0, 1] images, by the config's ``centered``."""

from __future__ import annotations


def get_inverse_scaler(centered: bool = True):
    return (lambda x: (x + 1.0) / 2.0) if centered else (lambda x: x)
