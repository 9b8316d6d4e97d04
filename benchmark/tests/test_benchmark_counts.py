"""``benchmark/counts`` against PyTorch's FLOP counter on the references at
small sizes (and at the CIFAR net's full width, one image)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.core import BENCH, load_file, read_json
from benchmark.harness.weights import fill_
from benchmark.reference.mmdit import MMDiT
from benchmark.reference.ncsnpp import NCSNpp
from benchmark.reference.text import T5, CLIPText
from benchmark.reference.vae import VAE
from bench_toy import CIFAR_SPEC, sd3_spec

CIFAR = load_file(BENCH / "counts" / "cifar10-ncsnpp-ddpmpp.py", "counts")
SD3 = load_file(BENCH / "counts" / "sd3-medium.py", "counts")


def counted(fn):
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def cifar_kwargs(spec):
    return dict(image_size=spec["image_size"],
                num_channels=spec["num_channels"], nf=spec["nf"],
                ch_mult=spec["ch_mult"],
                num_res_blocks=spec["num_res_blocks"],
                attn_resolutions=spec["attn_resolutions"])


@pytest.mark.parametrize("full", [False, True], ids=["toy", "published"])
def test_cifar_forward(full):
    spec = read_json(BENCH / "configs" / "cifar10-ncsnpp-ddpmpp.json")
    if not full:
        spec = dict(spec, **CIFAR_SPEC)
    batch = 1 if full else 3
    m = fill_(NCSNpp(**cifar_kwargs(spec)), 1, torch.float32, "cpu")
    r = spec["image_size"]
    got = counted(lambda: m(torch.zeros(batch, r, r, 3),
                            torch.full((batch,), 500.0)))
    assert CIFAR.forward_flops(spec, batch) == got
    if full:
        assert got == 21_693_071_360


def test_cifar_request_and_shapes():
    spec = read_json(BENCH / "configs" / "cifar10-ncsnpp-ddpmpp.json")
    tr = {"sweep": 1024, "micro": 64}
    assert CIFAR.request_flops(spec, tr) == 21_693_071_360 * 10 * 1024
    w = CIFAR.walk(spec, 64)
    assert len(w["conv3x3"]) == 90          # K3 88 and K2 2 a forward
    assert len(w["gn_k6"]) == 13            # K6 130 a 10-step run


def test_clip_t5():
    s = sd3_spec()
    for part in ("clip_l", "clip_g"):
        m = fill_(CLIPText(**s[part]), 1, torch.float32, "cpu")
        ids = torch.randint(1, 49406, (1, 8))
        assert SD3.clip_flops(s[part], 8) == counted(lambda: m(ids))
    m = fill_(T5(**s["t5"]), 1, torch.float32, "cpu")
    ids = torch.randint(2, 32100, (1, 12))
    assert SD3.t5_flops(s["t5"], 12) == counted(lambda: m(ids))


def test_mmdit_forward():
    mm = sd3_spec()["mmdit"]
    m = fill_(MMDiT(**mm), 1, torch.float32, "cpu")
    b, lat, ctx = 2, 16, 5
    got = counted(lambda: m(torch.zeros(b, lat, lat, 16),
                            torch.full((b,), 500.0),
                            torch.zeros(b, ctx, mm["joint_attention_dim"]),
                            torch.zeros(b, mm["pooled_projection_dim"])))
    assert SD3.mmdit_forward_flops(mm, b, lat, ctx) == got


def test_vae_decode():
    v = sd3_spec()["vae"]
    m = fill_(VAE(**v), 1, torch.float32, "cpu")
    got = counted(lambda: m.decode(torch.zeros(2, 8, 8, 16)))
    assert SD3.vae_decode_flops(v, 2, 8) == got


def test_sd3_request_at_published_sizes():
    """514 TFLOP a 1024x1024 request (the issue's ~510)."""
    spec = read_json(BENCH / "configs" / "sd3-medium.json")
    f = SD3.request_flops(spec, {"batch": 1, "latent": 128})
    assert 5.0e14 < f < 5.3e14
