"""Autograd around the kernels.

The training kernels K2, K3, K4 and K6 are ``torch.autograd.Function``s
(``ops/conv3x3.py``, ``ops/group_norm.py``): the forward is the kernel on a
CUDA tensor and the plain version on a CPU one, the backward is the
vector-Jacobian product of a library twin of the kernel's function
(``conv3x3_twin``, ``group_norm_twin``) on the saved inputs, written out
with cuDNN's convolution gradients, as the JAX package's custom VJPs
differentiate XLA twins of its Pallas kernels.

The inference kernels K1, K7, K8, K9, K10 and Q1 have no backward (JAX's
K9 and K10 differentiate through its library's attention kernels, which
the port has not taken over).  :func:`inference_only` keeps their outputs
in the graph under grad mode and makes a backward through them raise,
naming the kernel, instead of leaving the output silently detached.

Either way a call takes the Function only when grad mode is on and one of
its tensors requires grad (:func:`needs_grad`); otherwise it launches as an
inference call does, without ``Function.apply``'s host time.
"""

from __future__ import annotations

import functools

import torch


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None allowed) requires
    grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _NoBackward(torch.autograd.Function):
    """The output of an inference kernel in the graph: its backward
    raises."""

    @staticmethod
    def forward(ctx, label, call, *flat):
        ctx.label = label
        return call(*flat)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"{ctx.label} is an inference kernel and has no backward; call "
            f"it under torch.no_grad() or differentiate another route")


def inference_only(label: str):
    """Decorate the wrapper of an inference kernel: under grad mode, with a
    tensor argument that requires grad, its outputs come out of a Function
    whose backward raises an error naming ``label``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            flat = (*args, *kwargs.values())
            if not needs_grad(*flat):
                return fn(*args, **kwargs)
            names, n = list(kwargs), len(args)

            def call(*vals):
                return fn(*vals[:n], **dict(zip(names, vals[n:])))
            return _NoBackward.apply(label, call, *flat)
        return wrapper
    return deco
