"""The port against the benchmark's references at small sizes on the CPU,
in float32, with the same seeded weights (the port runs its kernels'
plain versions here).  The relative L2 limit 1e-5 is float32 rounding
through a few layers; the matrices agree to float64 rounding."""

import numpy as np
import pytest
import torch

from benchmark.harness.weights import fill_, param_shapes
from benchmark.reference import samplers
from benchmark.reference.mmdit import MMDiT as RefMMDiT
from benchmark.reference.ncsnpp import NCSNpp as RefNCSNpp
from benchmark.reference.text import T5, CLIPText
from benchmark.reference.vae import VAE
from bench_toy import sd3_spec

TOL = 1e-5


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def both(ref_cls, ref_kw, port):
    with torch.device("meta"):
        ref = ref_cls(**ref_kw)
    assert param_shapes(ref) == param_shapes(port)
    fill_(ref, 3, torch.float32, "cpu")
    fill_(port, 3, torch.float32, "cpu")
    return ref, port.eval()


def test_ncsnpp():
    from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
    kw = dict(image_size=16, num_channels=3, nf=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,))
    ref, port = both(RefNCSNpp, kw, NCSNpp(NCSNppConfig(**kw),
                                           device="meta"))
    x, t = torch.randn(2, 16, 16, 3), torch.tensor([300.0, 700.0])
    with torch.no_grad():
        assert rel(port(x, t), ref(x, t)) < TOL


def test_mmdit():
    from naturaldiffusion_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    m = sd3_spec()["mmdit"]
    ref, port = both(RefMMDiT, m, MMDiT(MMDiTConfig(**m), device="meta"))
    x = torch.randn(2, 16, 16, 16)
    t = torch.tensor([900.0, 100.0])
    ctx = torch.randn(2, 5, m["joint_attention_dim"])
    pooled = torch.randn(2, m["pooled_projection_dim"])
    with torch.no_grad():
        assert rel(port(x, t, ctx, pooled), ref(x, t, ctx, pooled)) < TOL


@pytest.mark.parametrize("part", ["clip_l", "clip_g"])
def test_clip(part):
    from naturaldiffusion_tpu_torch.models.text_encoders import (
        CLIPTextConfig, CLIPTextEncoder)
    c = sd3_spec()[part]
    ref, port = both(CLIPText, c, CLIPTextEncoder(CLIPTextConfig(**c),
                                                  device="cpu"))
    ids = torch.randint(1, 49406, (2, 8))
    ids[:, 0], ids[:, -1] = 49406, 49407
    with torch.no_grad():
        for a, b in zip(port(ids), ref(ids)):
            assert rel(a, b) < TOL


def test_t5():
    from naturaldiffusion_tpu_torch.models.text_encoders import (T5Config,
                                                                 T5Encoder)
    c = sd3_spec()["t5"]
    ref, port = both(T5, c, T5Encoder(T5Config(**c), device="cpu"))
    ids = torch.randint(2, 32100, (2, 12))
    with torch.no_grad():
        assert rel(port(ids), ref(ids)) < TOL


def test_vae_decode():
    from naturaldiffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    v = sd3_spec()["vae"]
    ref, port = both(VAE, v, AutoencoderKL(VAEConfig(
        **dict(v, ch_mult=tuple(v["ch_mult"]))), device="cpu"))
    z = torch.randn(1, 8, 8, 16)
    with torch.no_grad():
        assert rel(port.decode(port.unscale_latents(z)), ref.decode(z)) < TOL


@pytest.mark.parametrize("n", [10, 18, 100])
def test_ddpm_matrix(n):
    from naturaldiffusion_tpu_torch.coeffs import registry
    m = registry.derive("ddpm", n)
    x0, eps, node = samplers.ddpm_matrix(n)
    np.testing.assert_allclose(x0, m.x0, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(eps, m.eps, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(node, m.node, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n", [4, 28])
def test_sd3_matrix(n):
    from naturaldiffusion_tpu_torch.coeffs.sd3 import (sd3_euler_weights,
                                                       sd3_weight_matrix)
    m = sd3_weight_matrix(sd3_euler_weights(n, shift=3.0), n, shift=3.0)
    x0, eps, node = samplers.sd3_euler_matrix(n, 3.0)
    np.testing.assert_allclose(x0, m.x0, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(eps, m.eps, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(node, m.node, rtol=1e-12, atol=1e-12)


def test_ni_loop_against_the_port_engine():
    """The reference's float64 NI loop and the port's engine (float64 on
    the CPU) on one toy denoiser and the DDPM matrix."""
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.engine import NISchedule, natural_inference
    m = registry.derive("ddpm", 6)
    g = torch.Generator().manual_seed(0)
    init = torch.randn(3, 4, 4, 2, generator=g)
    noises = torch.randn(6, 3, 4, 4, 2, generator=g)
    w = torch.randn(2, 2, generator=g, dtype=torch.float64)

    def den(z, t):
        return torch.tanh(z.double() @ w) * (1 + float(t) / 1000)
    got = natural_inference(den, NISchedule.from_matrix(
        m, device="cpu", dtype=torch.float64), init.double(),
        noises=noises.double(), prediction_type="eps",
        accum_dtype=torch.float64)
    want = samplers.natural_inference(
        lambda z, t: den(z, t), *samplers.ddpm_matrix(6), init, noises)
    assert rel(got, want) < 1e-6
