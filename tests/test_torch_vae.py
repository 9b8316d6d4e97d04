"""The port's VAE against the JAX package's at a small AutoencoderKL (base
32 channels, ch_mult (1, 2), one resnet a block), in the SD VAE's and
SD3's latent layouts, every weight random from numpy and carried across by
``load_jax_params``: ``encode`` (mean and logvar, and a sample from an
explicit generator), ``decode``, the latent scalings, and the converter on
the torch twin's state dict against JAX's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models import vae as jv
from naturaldiffusion_tpu.models.convert import fill_from_torch as jfill
from naturaldiffusion_tpu_torch import models
from naturaldiffusion_tpu_torch.models import vae as tv
from naturaldiffusion_tpu_torch.models.convert import (fill_from_torch,
                                                       load_jax_params)
from torch_port_util import jax_params, rel_l2

torch.set_num_threads(2)

SMALL = dict(base_channels=32, ch_mult=(1, 2), layers_per_block=1)
F32_TOL = 1e-5
LAYOUTS = {"sd": jv.SD_VAE, "sd3": jv.SD3_VAE}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def pair(request):
    jcfg = dataclasses.replace(LAYOUTS[request.param], **SMALL)
    jmod = jv.AutoencoderKL(config=jcfg)
    params = jax_params(jmod, np.zeros((1, 16, 16, 3), np.float32))
    tcfg = tv.VAEConfig(**dataclasses.asdict(jcfg))
    tmod = load_jax_params(tv.AutoencoderKL(tcfg, device="cpu"), params)
    return jmod, params, tmod


def test_configs_are_jax():
    for name, cfg in (("SD_VAE", tv.SD_VAE), ("SD3_VAE", tv.SD3_VAE)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            getattr(jv, name))


def test_encode_matches_jax(pair):
    jmod, params, tmod = pair
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 12, 3)).astype(
        np.float32)
    mean, logvar = jmod.apply({"params": params}, x,
                              method=jv.AutoencoderKL.encode)
    with torch.no_grad():
        tmean, tlogvar = tmod.encode(_t(x))
    zc = tmod.config.latent_channels
    assert tmean.shape == tlogvar.shape == (2, 8, 6, zc)
    assert rel_l2(tmean.numpy(), np.asarray(mean)) < F32_TOL
    assert rel_l2(tlogvar.numpy(), np.asarray(logvar)) < F32_TOL
    # a sample: mean + exp(logvar / 2, clipped to [-30, 20]) * noise, the
    # noise from the generator
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        z = tmod.encode(_t(x), generator=g)
    noise = torch.randn(tmean.shape, generator=torch.Generator().manual_seed(3))
    want = tmean + torch.exp(0.5 * tlogvar.clamp(-30.0, 20.0)) * noise
    torch.testing.assert_close(z, want)


def test_decode_matches_jax(pair):
    jmod, params, tmod = pair
    zc = tmod.config.latent_channels
    z = np.random.default_rng(2).standard_normal((2, 5, 7, zc)).astype(
        np.float32)
    want = np.asarray(jmod.apply({"params": params}, z,
                                 method=jv.AutoencoderKL.decode))
    with torch.no_grad():
        got = tmod.decode(_t(z)).numpy()
    assert got.shape == want.shape == (2, 10, 14, 3)
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < F32_TOL


def test_forward_and_scalings_match_jax(pair):
    jmod, params, tmod = pair
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, x))
    with torch.no_grad():
        got = tmod(_t(x)).numpy()
    assert rel_l2(got, want) < F32_TOL
    z = rng.standard_normal((2, 4, 4, tmod.config.latent_channels)).astype(
        np.float32)
    for name in ("scale_latents", "unscale_latents"):
        np.testing.assert_allclose(
            getattr(tmod, name)(_t(z)).numpy(),
            np.asarray(getattr(jmod, name)(z)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tmod.unscale_latents(tmod.scale_latents(_t(z))).numpy(), z,
        rtol=1e-5, atol=1e-6)


def test_fill_from_torch_matches_jax_converter():
    """The twin's state dict (diffusers' names, two resnets a block)
    through both converters: the same parameters, no key unused, and the
    port's path map is JAX's on every parameter."""
    from torch_vae_twin import TorchAutoencoderKL
    torch.manual_seed(0)
    twin = TorchAutoencoderKL(cin=3, ch=32, mults=(1, 2), layers=2, zc=4)
    sd = twin.state_dict()
    jcfg = jv.VAEConfig(base_channels=32, ch_mult=(1, 2), layers_per_block=2,
                        latent_channels=4)
    jmod = jv.AutoencoderKL(config=jcfg)
    want, junused = jfill(jax_params(jmod, np.zeros((1, 16, 16, 3),
                                                    np.float32)),
                          sd, path_map=jv.vae_torch_path_map)
    port = tv.AutoencoderKL(tv.VAEConfig(**dataclasses.asdict(jcfg)),
                            device="cpu")
    assert fill_from_torch(port, sd, path_map=tv.vae_torch_path_map) \
        == junused == []
    flat = {".".join(k.key for k in kp): np.asarray(leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    own = dict(port.named_parameters())
    assert own.keys() == flat.keys()
    for name, prm in own.items():
        np.testing.assert_array_equal(prm.detach().numpy(), flat[name])
        path = tuple(name.split("."))[:-1]
        assert tv.vae_torch_path_map(path) == jv.vae_torch_path_map(path)
    # the decode through the twin's weights is the twin's
    z = torch.randn(1, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_img = twin.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got_img = port.decode(z)
    assert rel_l2(got_img.numpy(), want_img.numpy()) < F32_TOL


def _twin_without_quant_convs():
    from torch_vae_twin import TorchAutoencoderKL
    torch.manual_seed(5)
    twin = TorchAutoencoderKL(cin=3, ch=32, mults=(1, 2), layers=1, zc=4)
    return {k: v for k, v in twin.state_dict().items()
            if not k.startswith(("quant_conv.", "post_quant_conv."))}


def test_missing_quant_conv_is_refused_by_jax():
    """SD3's checkpoint has no ``quant_conv``: JAX's converter raises on
    it (its comment says such keys are skipped; recorded, not copied)."""
    sd = _twin_without_quant_convs()
    jmod = jv.AutoencoderKL(config=jv.VAEConfig(**SMALL))
    with pytest.raises(KeyError, match="quant_conv"):
        jfill(jax_params(jmod, np.zeros((1, 8, 8, 3), np.float32)), sd,
              path_map=jv.vae_torch_path_map)


def test_missing_quant_conv_loads_as_identity():
    """The port loads a state dict without ``quant_conv`` and
    ``post_quant_conv`` as identity 1x1 convs with zero bias: its encode
    mean and decode equal JAX's with those two convs set so by hand.  Any
    other missing key, or a conv present in part, still raises."""
    sd = _twin_without_quant_convs()
    port = tv.AutoencoderKL(tv.VAEConfig(**SMALL), device="cpu")
    assert fill_from_torch(port, sd, path_map=tv.vae_torch_path_map) == []
    zc2 = 2 * port.config.latent_channels
    np.testing.assert_array_equal(port.quant_conv.kernel.detach().numpy(),
                                  np.eye(zc2).reshape(1, 1, zc2, zc2))
    assert not port.post_quant_conv.bias.detach().any()
    # JAX: the same state dict with the two convs written in by hand
    hand = dict(sd)
    for conv, c in (("quant_conv", zc2), ("post_quant_conv", zc2 // 2)):
        hand[f"{conv}.weight"] = torch.eye(c).reshape(c, c, 1, 1)
        hand[f"{conv}.bias"] = torch.zeros(c)
    jmod = jv.AutoencoderKL(config=jv.VAEConfig(**SMALL))
    params, unused = jfill(jax_params(jmod, np.zeros((1, 8, 8, 3),
                                                     np.float32)),
                           hand, path_map=jv.vae_torch_path_map)
    assert unused == []
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 16, 8, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4, 3, zc2 // 2)).astype(np.float32)
    mean, _ = jmod.apply({"params": params}, x,
                         method=jv.AutoencoderKL.encode)
    img = jmod.apply({"params": params}, z, method=jv.AutoencoderKL.decode)
    with torch.no_grad():
        tmean, _ = port.encode(_t(x))
        timg = port.decode(_t(z))
    assert np.abs(np.asarray(img)).max() > 0.1
    assert rel_l2(tmean.numpy(), np.asarray(mean)) < F32_TOL
    assert rel_l2(timg.numpy(), np.asarray(img)) < F32_TOL
    # every other key still raises
    fresh = tv.AutoencoderKL(tv.VAEConfig(**SMALL), device="cpu")
    for drop in ("encoder.conv_in.weight", "decoder.conv_out.bias"):
        with pytest.raises(KeyError, match=drop.rpartition(".")[0]):
            fill_from_torch(fresh, {k: v for k, v in sd.items()
                                    if k != drop},
                            path_map=tv.vae_torch_path_map)
    part = dict(sd, **{"quant_conv.weight": hand["quant_conv.weight"]})
    with pytest.raises(KeyError, match="quant_conv.bias"):
        fill_from_torch(fresh, part, path_map=tv.vae_torch_path_map)


def test_create_model_builds_the_vae():
    net = models.create_model("vae", device="cpu", **SMALL)
    assert isinstance(net, models.AutoencoderKL)
    assert net.config == tv.VAEConfig(**SMALL)
