"""``.pth`` loading in the port (``models/convert.py``) against the JAX
package's: the synthetic checkpoint layouts of
``tests/test_convert_coverage.py`` loaded by both to equal arrays; then one
torch state dict, built in the test from random numpy arrays in the
reference's names and layouts, fills a small NCSN++ and a small DiT in
both packages (``fill_from_torch``), whose forwards must agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.models import convert as jconvert
from naturaldiffusion_tpu.models import dit as jdit
from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu_torch.models import convert, dit
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import (SMALL, random_flax_params, rel_l2,
                             torch_state_dict)

torch.set_num_threads(2)

# float32 forwards on both sides, sums in other orders (the NCSN++ and DiT
# port tests' limit)
F32_TOL = 1e-5
DIT_CFG = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
               depth=2, num_heads=4, num_classes=10)


class _TinyNet(torch.nn.Module):
    """Conv + BN (buffers) + linear, as tests/test_convert_coverage.py:
    enough to catch an ordering fault between parameters() and
    state_dict()."""

    def __init__(self):
        super().__init__()
        self.register_buffer("sigmas", torch.linspace(1.0, 0.01, 5))
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.fc = torch.nn.Linear(4, 2)


def _layouts(tmp_path):
    torch.manual_seed(0)
    net = _TinyNet()
    shadows = [p.detach().clone() + 0.123 for p in net.parameters()]
    sd = {"module." + k: v for k, v in net.state_dict().items()}
    score = {"model": sd, "ema": {"decay": 0.9999, "num_updates": 7,
                                  "shadow_params": shadows},
             "optimizer": {"state": {}, "param_groups": []}, "step": 80000}
    ema = {k: v + 1.0 for k, v in net.state_dict().items()}
    out = {"score_sde": score, "dit": {"model": net.state_dict(), "ema": ema},
           "model_only": {"model": sd}, "bare": net.state_dict()}
    for name, obj in out.items():
        torch.save(obj, tmp_path / f"{name}.pth")
    return net


@pytest.mark.parametrize("layout", ["score_sde", "dit", "model_only",
                                    "bare"])
def test_checkpoint_layouts_load_as_jax_loads_them(tmp_path, layout):
    net = _layouts(tmp_path)
    path = str(tmp_path / f"{layout}.pth")
    got, want = convert.load_torch_checkpoint(path), \
        jconvert.load_torch_checkpoint(path)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if layout == "score_sde":      # EMA params, model buffers
        np.testing.assert_allclose(
            got["conv.weight"], net.conv.weight.detach().numpy() + 0.123,
            atol=1e-6)
        np.testing.assert_array_equal(got["sigmas"], net.sigmas.numpy())
    assert not any(k.startswith("module.") for k in got)


def test_shadow_misalignment_raises(tmp_path):
    _layouts(tmp_path)
    ckpt = torch.load(tmp_path / "score_sde.pth", weights_only=False)
    del ckpt["ema"]["shadow_params"][0]
    torch.save(ckpt, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="misalignment"):
        convert.load_torch_checkpoint(str(tmp_path / "bad.pth"))
    assert convert.strip_prefixes({"module.model.a": 1, "b": 2}) == \
        jconvert.strip_prefixes({"module.model.a": 1, "b": 2})


def test_ncsnpp_filled_from_one_state_dict_matches_jax():
    jm = JaxNCSNpp(config=JaxConfig(**SMALL))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 3), jnp.float32),
                          jnp.zeros((1,), jnp.float32))["params"],
        jax.random.PRNGKey(0))
    template = random_flax_params(shapes, np.random.default_rng(0))
    sd = torch_state_dict(template, convert.ncsnpp_torch_path_map,
                      np.random.default_rng(1))
    params, junused = jconvert.fill_from_torch(template, sd)
    model = NCSNpp(NCSNppConfig(**SMALL), device="cpu")
    unused = convert.fill_from_torch(model, sd)
    assert unused == junused == ["sigmas"]
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    t = np.array([999.0, 420.0], np.float32)
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < F32_TOL
    with pytest.raises(KeyError, match="missing torch key"):
        convert.fill_from_torch(model, {k: v for k, v in sd.items()
                                        if not k.startswith("all_modules.0")})
    bad = dict(sd, **{"all_modules.0.bias": torch.zeros(7)})
    with pytest.raises(ValueError, match="all_modules.0.bias"):
        convert.fill_from_torch(model, bad)


def test_dit_filled_from_one_state_dict_matches_jax():
    jm = jdit.DiT(config=jdit.DiTConfig(**DIT_CFG))
    shapes = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 8, 8, 4), jnp.float32),
                          jnp.zeros((1,), jnp.float32),
                          jnp.zeros((1,), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    template = random_flax_params(shapes, np.random.default_rng(3))
    sd = torch_state_dict(template, jdit.dit_torch_path_map,
                      np.random.default_rng(4))
    assert all(dit.dit_torch_path_map(tuple(k.split("."))) ==
               jdit.dit_torch_path_map(tuple(k.split("."))) for k in
               ("blocks_1.adaLN_modulation_1", "x_embedder_proj",
                "t_embedder_mlp_2", "y_embedder_embedding_table",
                "final_layer.linear"))
    params, _ = jconvert.fill_from_torch(template, sd,
                                         path_map=jdit.dit_torch_path_map)
    model = dit.DiT(dit.DiTConfig(**DIT_CFG), device="cpu")
    assert convert.fill_from_torch(model, sd,
                                   path_map=dit.dit_torch_path_map) == \
        ["sigmas"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 420.0], np.float32)
    y = np.array([3, 10], np.int32)
    want = np.asarray(jm.apply({"params": params}, x, t, y))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(y).long()).numpy()
    assert np.abs(want).max() > 0.1
    assert rel_l2(got, want) < F32_TOL
