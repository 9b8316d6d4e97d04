"""The port's config zoo and model registry against the JAX package's: all
39 entries field by field with their family, ``create_model`` building each
ported family at full width with JAX's parameter count, and the families
that wait for their slice refused (the four NCSN++ entries the zoo gained
run in ``test_torch_ncsnpp_zoo.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu import models as jmodels
from naturaldiffusion_tpu.configs import CONFIGS as JAX_CONFIGS
from naturaldiffusion_tpu.configs import get_config as jax_get_config
from naturaldiffusion_tpu_torch import configs, models

torch.set_num_threads(2)

SDE_CLASSES = {"vesde": "VESDE", "vpsde": "VPSDE", "subvpsde": "SubVPSDE"}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_entry_matches_jax_field_by_field(name):
    mine, ref = configs.get_config(name), jax_get_config(name)
    assert mine.name == ref.name
    assert mine.model_family == ref.model_family
    assert type(mine.model).__name__ == type(ref.model).__name__
    for f in dataclasses.fields(mine.model):
        assert getattr(mine.model, f.name) == getattr(ref.model, f.name), f
    assert {f.name for f in dataclasses.fields(ref.model)} - {
        f.name for f in dataclasses.fields(mine.model)} <= {
        "dropout", "num_train_timesteps"}
    for f in dataclasses.fields(mine.sde):
        assert getattr(mine.sde, f.name) == getattr(ref.training, f.name), f
    assert dataclasses.asdict(mine.sampling) == dataclasses.asdict(
        ref.sampling)
    assert type(configs.get_sde(mine)).__name__ == \
        SDE_CLASSES[ref.training.sde]


def test_every_entry_resolves():
    assert sorted(configs.CONFIGS) == sorted(JAX_CONFIGS)
    assert len(configs.CONFIGS) == 39
    with pytest.raises(KeyError):
        configs.get_config("ve/no_such_entry")


# one full-width entry of each ported family, and its input size
FAMILY_ENTRIES = {"ddpm": "vp/ddpm/cifar10", "ncsn": "ve/ncsn/cifar10",
                  "ncsnv2_64": "ve/ncsnv2/cifar10",
                  "ncsnv2_128": "ve/ncsnv2/bedroom",
                  "ncsnv2_256": None,
                  "ncsnpp": "ve/celebahq_ncsnpp_continuous"}


@pytest.mark.parametrize("family", sorted(FAMILY_ENTRIES))
def test_create_model_builds_each_family_at_full_width(family):
    """The port's registry against the JAX package's (``models._MODELS``):
    the same family names build the same classes, with JAX's parameter
    count at full width (the JAX tree by shape only)."""
    name = FAMILY_ENTRIES[family]
    cfg = (configs.get_config(name).model if name else
           models.NCSNv2Config(image_size=256))
    jcls, jcfg_cls = jmodels.get_model(family)
    cls, cfg_cls = models.get_model(family)
    assert (cls.__name__, cfg_cls.__name__) == (jcls.__name__,
                                                jcfg_cls.__name__)
    net = models.create_model(family, cfg, device="cpu")
    assert type(net) is cls
    jm = jmodels.create_model(family, jcfg_cls(**dataclasses.asdict(cfg)))
    n = cfg.image_size
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: jm.init(k, jnp.zeros((1, n, n, 3), jnp.float32),
                              jnp.ones((1,), jnp.float32))["params"],
            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes))
    assert sum(p.numel() for p in net.parameters()) == want


def test_create_model_takes_config_fields():
    net = models.create_model("ddpm", device="cpu", nf=32,
                              ch_mult=(1,), attn_resolutions=())
    assert net.config == models.DDPMConfig(nf=32, ch_mult=(1,),
                                           attn_resolutions=())


@pytest.mark.parametrize("family", ["mmdit", "vae"])
def test_unported_families_are_refused(family):
    assert family in jmodels._MODELS
    with pytest.raises(KeyError, match="SD3"):
        models.create_model(family)
