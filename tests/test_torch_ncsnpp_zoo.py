"""The four NCSN++ entries of the config zoo that the port gained with the
other backbones (``ve/cifar10_ncsnpp``, ``ve/cifar10_ncsnpp_deep_continuous``
and the 1024^2 pair ``ve/celebahq_ncsnpp_continuous``,
``ve/ffhq_ncsnpp_continuous``), each in its form at a reduced size, against
the JAX NCSN++ with the same weights (f32, CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturaldiffusion_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from naturaldiffusion_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from naturaldiffusion_tpu_torch import configs
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from naturaldiffusion_tpu_torch.models.layers import PConv3x3
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from torch_port_util import jax_params, rel_l2

torch.set_num_threads(2)

# f32 on both sides, sums in other orders (as test_torch_ncsnpp.py)
TOL = 1e-5

# the four NCSN++ entries the zoo gained, in their forms at a reduced size:
# the CIFAR pair at 16^2 (nf 16, one block a level, attention at 8^2), the
# 1024^2 pair with all 8 levels at 128^2 and nf 4 (channels 4 to 128), so
# their C < 128 convs run K2's plain version as on the card
NEW_NCSNPP = {
    "ve/cifar10_ncsnpp": dict(image_size=16, nf=16, num_res_blocks=1,
                              attn_resolutions=(8,)),
    "ve/cifar10_ncsnpp_deep_continuous": dict(
        image_size=16, nf=16, num_res_blocks=2, attn_resolutions=(8,)),
    "ve/celebahq_ncsnpp_continuous": dict(image_size=128, nf=4),
    "ve/ffhq_ncsnpp_continuous": dict(image_size=128, nf=4),
}


@pytest.mark.parametrize("name", sorted(NEW_NCSNPP))
def test_new_ncsnpp_entries_forms_match_jax(name, monkeypatch):
    """The port at its default switch (``2``), JAX at its own (``0``): the
    same function.  The positional entry's ``scale_by_sigma`` reads the
    VE sigma table at the timestep labels."""
    cfg = configs.get_config(name)
    kw = dict(dataclasses.asdict(cfg.model), **NEW_NCSNPP[name])
    positional = cfg.model.embedding_type == "positional"
    sigmas = (np.geomspace(cfg.sde.sigma_max, cfg.sde.sigma_min,
                           cfg.sde.num_scales).astype(np.float32)
              if positional else None)
    n = kw["image_size"]
    x = np.random.default_rng(1).uniform(size=(2, n, n, 3)).astype(
        np.float32)
    t = (np.array([999.0, 420.0], np.float32) if positional
         else np.array([50.0, 0.3], np.float32))
    jm = JaxNCSNpp(config=JaxConfig(**kw),
                   **({"sigmas": tuple(sigmas)} if positional else {}))
    params = jax_params(jm, jnp.asarray(x), jnp.asarray(t), seed=2)
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "0")
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)), np.float32)
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "2")
    tm = load_jax_params(NCSNpp(NCSNppConfig(**kw), sigmas=sigmas,
                                device="cpu"), params)
    routes = []

    def hook(mod, args, kwargs, out):
        if kwargs.get("pre") is None and not kwargs.get("emit_stats"):
            routes.append((args[0].shape[-1], mod.kernel.shape[3],
                           mod.route(args[0])))

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in tm.modules() if isinstance(m, PConv3x3)]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    for h in hooks:
        h.remove()
    assert {r for ci, co, r in routes if min(ci, co) < 128} == {"K2"}
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0.05
    assert rel_l2(got, want) < TOL
