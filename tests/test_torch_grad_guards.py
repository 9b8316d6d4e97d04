"""The inference kernels' guards: under grad mode, with an input that
requires grad, K1, K7, K8, K9, K10 and Q1 (their plain routes here) keep
their output in the graph and a backward through it raises an error naming
the kernel; without grad the call returns a plain tensor.  The training
kernels K2, K3, K4 and K6 take their Functions only under grad; and the
inference entry points run under ``torch.no_grad``."""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu_torch.ops import attention, fused_act, qmatmul, quant
from naturaldiffusion_tpu_torch.ops import conv3x3, group_norm, weighted_sum

torch.set_num_threads(2)


def _t(*shape, grad=True, seed=0):
    g = torch.Generator().manual_seed(seed + len(shape))
    return torch.randn(shape, generator=g).requires_grad_(grad)


def _k7(x):
    w_i8 = torch.randint(-127, 128, (128, 128), dtype=torch.int8)
    return qmatmul.matmul_wdq(x, w_i8, torch.ones(128), bias=None)


GUARDED = {
    "fused_weighted_sum (K1)": (
        lambda a: weighted_sum.fused_weighted_sum(
            a, torch.ones(3), torch.ones(3, 8), torch.ones(3, 8), 3, 3),
        (3,)),
    "matmul_wdq (K7)": (_k7, (16, 128)),
    "fused_leaky_relu_pallas (K8)": (
        lambda a: fused_act.fused_leaky_relu_pallas(a, torch.zeros(8)),
        (2, 8)),
    "flash_attention (K9)": (
        lambda a: attention.flash_attention(a, a, a, 0.25), (1, 2, 8, 16)),
    "splash_attention (K10)": (
        lambda a: attention.splash_attention(a, a, a, 0.25), (1, 2, 8, 16)),
    "conv3x3_int8 (Q1)": (
        lambda a: quant.conv3x3_int8(a, torch.ones(3, 3, 8, 8) * 0.1),
        (1, 4, 4, 8)),
}


@pytest.mark.parametrize("label", sorted(GUARDED))
def test_backward_raises_naming_the_kernel(label):
    fn, shape = GUARDED[label]
    out = fn(_t(*shape))
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None and out.requires_grad
    with pytest.raises(RuntimeError, match=label.replace("(", r"\(")
                       .replace(")", r"\)")):
        out.float().sum().backward()


@pytest.mark.parametrize("label", sorted(GUARDED))
def test_no_graph_without_grad(label):
    fn, shape = GUARDED[label]
    with torch.no_grad():
        out = fn(_t(*shape))
    assert not out.requires_grad and out.grad_fn is None
    out = fn(_t(*shape, grad=False))
    assert out.grad_fn is None


def test_guard_sees_a_keyword_tensor():
    """A bias passed by keyword that requires grad is an input too."""
    x = _t(16, 128, grad=False)
    w_i8 = torch.randint(-127, 128, (128, 128), dtype=torch.int8)
    out = qmatmul.matmul_wdq(x, w_i8, torch.ones(128),
                             bias=_t(128))
    with pytest.raises(RuntimeError, match="K7"):
        out.sum().backward()


def test_training_kernels_take_their_functions_only_under_grad():
    x, w = _t(1, 4, 4, 8), _t(3, 3, 8, 8)
    assert type(conv3x3.conv3x3(x, w).grad_fn).__name__ == "_ConvFnBackward"
    assert type(conv3x3.conv3x3_tiled(x, w).grad_fn).__name__ \
        == "_ConvFnBackward"
    y = group_norm.fused_group_norm(x, torch.ones(8), torch.zeros(8), 2)
    assert type(y.grad_fn).__name__ == "_GroupNormFnBackward"
    with torch.no_grad():
        assert conv3x3.conv3x3_gn(x, w, emit_stats=True)[0].grad_fn is None
    # no input requires grad: the direct call
    assert conv3x3.conv3x3(x.detach(), w.detach()).grad_fn is None


def test_natural_inference_runs_without_grad():
    """The NI engine runs its model under no_grad: a model with parameters
    that require grad leaves no graph behind."""
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.engine.ni import (NISchedule,
                                                      natural_inference)
    lin = torch.nn.Linear(4, 4)
    seen = []

    def denoise(x, t):
        seen.append(torch.is_grad_enabled())
        return lin(x)

    sched = NISchedule.from_matrix(registry.derive("ddim", 3), device="cpu")
    z = natural_inference(denoise, sched, torch.randn(2, 4))
    assert seen and not any(seen) and not z.requires_grad
    assert np.isfinite(z.numpy()).all()
