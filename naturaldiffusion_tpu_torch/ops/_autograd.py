"""Autograd around the kernels.

The training kernels K2, K3, K4 and K6 are ``torch.autograd.Function``s
(``ops/conv3x3.py``, ``ops/group_norm.py``): the forward is the kernel on a
CUDA tensor and the plain version on a CPU one, the backward is the
vector-Jacobian product of a library twin of the kernel's function
(``conv3x3_twin``, ``group_norm_twin``) on the saved inputs, written out
with cuDNN's convolution gradients, as the JAX package's custom VJPs
differentiate XLA twins of its Pallas kernels.

The attention kernels K9 and K10 are a Function too
(``ops/attention.py:_AttentionFn``) whose backward is a kernel of its own
(``csrc/attention_bwd.cu``), as JAX differentiates them through its
library's backward kernels.

The inference kernels K1, K7, K8 and Q1 have no backward.
:func:`inference_only` keeps their outputs in the graph under grad mode
and makes a backward through them raise, naming the kernel, instead of
leaving the output silently detached (:class:`NoBackward`, which also
stands for K9's and K10's missing second derivative).

Either way a call takes the Function only when grad mode is on and one of
its tensors requires grad (:func:`needs_grad`); otherwise it launches as an
inference call does, without ``Function.apply``'s host time.
"""

from __future__ import annotations

import functools
import sys

import torch


def is_dtensor(x) -> bool:
    """``x`` is a DTensor.  Read without importing
    ``torch.distributed.tensor`` (seconds of import on a slow host): until
    something has imported it, no DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None allowed) requires
    grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_dtensor(what: str, *tensors) -> None:
    """A kernel reads raw pointers, which a DTensor does not have: raise
    rather than take another path.  The caller converts at its boundary
    (``to_local()`` / ``DTensor.from_local``)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{what}: the kernels take local tensors, got a "
                        f"DTensor; convert it at the model's boundary "
                        f"(to_local / from_local)")


class NoBackward(torch.autograd.Function):
    """``call(*flat)`` in the graph: its backward raises ``message``."""

    @staticmethod
    def forward(ctx, message, call, *flat):
        ctx.message = message
        return call(*flat)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.message)


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
            return NoBackward.apply(
                f"{label} is an inference kernel and has no backward; call "
                f"it under torch.no_grad() or differentiate another route",
                call, *flat)
        return wrapper
    return deco
