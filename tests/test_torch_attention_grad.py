"""K9's and K10's backward (``csrc/attention_bwd.cu``) through its plain
version, ``attention_backward_reference``, here on the CPU: the gradients
of the port's ``flash_attention`` / ``splash_attention`` Functions against
``jax.grad`` of the JAX package's ``mha(backend="flash")`` under
``pltpu.force_tpu_interpret_mode()`` (the library's flash backward kernels
in interpret mode) and of ``mha(backend="splash_interpret")`` (splash's
backward kernels), f32, a ragged T and head dims 64 and 72; the plain
backward against autograd of the softmax attention in float64; and the
limits: no second derivative, ``mha_joint`` has no gradient, a DTensor is
refused."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.ops.attention import mha as jax_mha
from naturaldiffusion_tpu_torch.ops import attention as A

torch.set_num_threads(2)

# f32 on both sides, sums in other orders; relative L2 of each gradient
TOL = 1e-5


def _inputs(t, d, b=1, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, t, d)).astype(np.float32)
                 for _ in range(4))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_grads(q, k, v, do, backend):
    def f(q_, k_, v_):
        return jnp.sum(jax_mha(q_, k_, v_, backend=backend) * do)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    if backend == "flash":
        with pltpu.force_tpu_interpret_mode():
            return jax.grad(f, argnums=(0, 1, 2))(*args)
    return jax.grad(f, argnums=(0, 1, 2))(*args)


def _port_grads(q, k, v, do, backend):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.mha(q, k, v, backend=backend)
    return torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))


@pytest.mark.parametrize("backend", ["flash", "splash"])
@pytest.mark.parametrize("t,d", [(200, 64), (130, 72)])
def test_backward_matches_jax(t, d, backend):
    """T = 200 and 130 are ragged: JAX pads them and masks the pad keys by
    segment ids; the port's kernel masks keys past T itself."""
    q, k, v, do = _inputs(t, d)
    want = _jax_grads(q, k, v, do, "flash" if backend == "flash"
                      else "splash_interpret")
    got = _port_grads(q, k, v, do, backend)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("d", [16, 32, 64, 72])
def test_plain_backward_against_float64_autograd(d):
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(37, d, b=2, seed=d))
    scale = 0.7 / math.sqrt(d)
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
    out = torch.softmax(qg @ kg.transpose(-1, -2) * scale, -1) @ vg
    want = torch.autograd.grad(out, (qg, kg, vg), do)
    lse = torch.logsumexp(q @ k.transpose(-1, -2) * scale, -1)
    got = A.attention_backward_reference(q, k, v, out.detach(), do, lse,
                                         scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_function_saves_the_logsumexp_and_counts_only_the_card():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(40, 16, b=2))
    before = (A.flash_attention.launches, A.flash_attention_backward.launches)
    qg, kg, vg = (a.clone().requires_grad_() for a in (q, k, v))
    out = A.flash_attention(qg, kg, vg, 0.3)
    assert type(out.grad_fn).__name__ == "_AttentionFnBackward"
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    lse = torch.logsumexp((q @ k.transpose(-1, -2)) * 0.3, -1)
    want = A.flash_attention_backward(q, k, v, out.detach(), do, lse, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # the plain versions on the CPU launch no kernel
    assert (A.flash_attention.launches,
            A.flash_attention_backward.launches) == before


def test_splash_gradient_reaches_q_through_the_prescale():
    """K10 differentiates at scale 1 on the pre-scaled q; q's gradient is
    the pre-scaled one's times the scale, as JAX's pre-scaling product
    gives it."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(33, 32, seed=3))
    g_splash = _port_grads(*(a.numpy() for a in (q, k, v, do)), "splash")
    g_flash = _port_grads(*(a.numpy() for a in (q, k, v, do)), "flash")
    for a, b in zip(g_splash, g_flash):
        assert _rel(a.numpy(), b.numpy()) < 1e-6


def test_mha_joint_has_no_gradient():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(520, 16)[:3])
    with pytest.raises(NotImplementedError, match="Higher-order AD"):
        A.mha_joint(q, k, v, split=512, interpret=True)
    with torch.no_grad():     # without grad it runs
        assert A.mha_joint(q, k, v, split=512, interpret=True).shape \
            == q.shape


def test_save_residuals_under_grad_raises():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(16, 16)[:3])
    with pytest.raises(NotImplementedError, match="no VJP"):
        A.splash_attention(q, k, v, 0.25, save_residuals=True)


def test_backward_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(16, 16))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="shape"):
        A.flash_attention_backward(q, k[:, :, :8], v, q, do, lse, 0.25)


def test_kernels_refuse_a_dtensor():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from naturaldiffusion_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    assert dist.get_world_size() == 1
    q = torch.randn(1, 2, 16, 16)
    dq = DTensor.from_local(q, mesh, [Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        A.flash_attention(dq, dq, dq, 0.25)
    with pytest.raises(TypeError, match="DTensor"):
        A.flash_attention_backward(dq, dq, dq, dq, dq, torch.zeros(1, 2, 16),
                                   0.25)
