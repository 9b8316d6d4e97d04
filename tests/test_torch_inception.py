"""The port's FID Inception (``naturaldiffusion_tpu_torch/eval/inception.py``)
against the JAX package's ``FIDInceptionV3``: one numpy-drawn parameter
tree through both (the port's copy by ``load_jax_params``), pool features
and IS logits at 32², at 48x64 and above 299 (the antialiased resize), and
the two packages' converters on a pytorch-fid-layout state dict built by
the tests' torch twin.

JAX's Inception is slow on this CPU, so it runs once, jitted, on the four
inputs resized by ``jax.image.resize`` and stacked (``resize_input=False``
from there): the same function as the JAX model on each input, one trace.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (binds torch's CPU math first)
from naturaldiffusion_tpu.eval import inception as JI
from naturaldiffusion_tpu_torch.eval import inception as PI
from naturaldiffusion_tpu_torch.models.convert import load_jax_params
from torch_inception_twin import random_twin

torch.set_num_threads(4)

# the inputs of the parity check: two CIFAR images, a rectangle, and one
# larger than 299 in both dimensions (the antialiased resize)
SIZES = ((2, 32, 32), (1, 48, 64), (1, 320, 336))
# f32 both sides, the same products in other orders through ~95 convs:
# rel. L2 of pool and logits, and elementwise against max |ref|; JAX's own
# parity test holds its Inception to the torch twin at atol = rtol = 2e-3
FEAT_REL_L2 = 1e-5
FEAT_MAX_ABS = 2e-5
# the resize alone, absolute on [0, 1] pixels: JAX computes its weights in
# float64 under the tests' x64, the port in f32 (~1.5e-6 upsampling); the
# antialiased weights are normalised sums (~1e-5 at a 320 -> 299 shrink)
RESIZE_TOL = {False: 5e-6, True: 3e-5}


def _draw(shapes, rng):
    """A tree of ``shapes`` drawn from ``rng``: kernels He-normal (features
    stay O(1) through 94 ReLU convs), BatchNorm as the twin's random
    statistics (scale 1 + 0.1 N, bias and mean 0.1 N, var U(0.5, 1.5)),
    the dense bias 0.1 N."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _draw(v, rng)
            continue
        s = tuple(v.shape)
        if k == "kernel":
            a = rng.standard_normal(s) * math.sqrt(2.0 / math.prod(s[:-1]))
        elif k == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, s)
        else:
            a = 0.1 * rng.standard_normal(s)
        out[k] = a.astype(np.float32)
    return out


def _inputs():
    rng = np.random.default_rng(7)
    return [rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
            for n, h, w in SIZES]


@pytest.fixture(scope="module")
def both():
    model = JI.FIDInceptionV3(with_logits=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    params = _draw(shapes, np.random.default_rng(0))
    trunk = JI.FIDInceptionV3(resize_input=False, with_logits=True)
    fwd = jax.jit(lambda x: trunk.apply({"params": params}, x))
    xs = _inputs()
    resized = jnp.concatenate([
        jax.image.resize(jnp.asarray(x), (len(x), 299, 299, 3), "bilinear")
        for x in xs])
    pool, logits = (np.asarray(a) for a in fwd(resized))
    port = load_jax_params(PI.FIDInceptionV3(with_logits=True), params)
    return port.eval(), xs, pool, logits


@pytest.mark.parametrize("i", range(len(SIZES)),
                         ids=[f"{h}x{w}" for _, h, w in SIZES])
def test_pool_and_logits_match_jax(both, i):
    port, xs, pool, logits = both
    lo = sum(n for n, _, _ in SIZES[:i])
    hi = lo + SIZES[i][0]
    with torch.no_grad():
        got_pool, got_logits = port(torch.from_numpy(xs[i]))
    for got, want in ((got_pool.numpy(), pool[lo:hi]),
                      (got_logits.numpy(), logits[lo:hi])):
        assert got.shape == want.shape
        assert np.abs(want).max() > 1e-2      # O(1) features, not ~0
        assert torch_port_util.rel_l2(got, want) < FEAT_REL_L2
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FEAT_MAX_ABS * np.abs(want).max())


def test_pool_only_model_is_the_logits_models_pool(both):
    port, xs, pool, _ = both
    plain = PI.FIDInceptionV3()
    plain.load_state_dict({k: v for k, v in port.state_dict().items()
                           if not k.startswith("fc.")})
    with torch.no_grad():
        got = plain(torch.from_numpy(xs[0])).numpy()
    assert torch_port_util.rel_l2(got, pool[:SIZES[0][0]]) < FEAT_REL_L2


@pytest.mark.parametrize("n,h,w", SIZES + ((1, 400, 200),))
def test_resize_matches_jax_image_resize(n, h, w):
    x = np.random.default_rng(h * w).uniform(0, 1, (n, h, w, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n, 299, 299, 3),
                                       "bilinear"))
    got = PI.resize_299(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_TOL[h > 299 or w > 299])


@pytest.mark.parametrize("with_logits", [False, True])
def test_converter_matches_jax(with_logits):
    """``convert_fid_inception_state`` of both packages on the twin's
    torchvision-layout state dict (with an ``AuxLogits`` key and the BN
    ``num_batches_tracked`` buffers, which both drop): the same leaves and
    the same unused keys."""
    sd = {k: v.numpy() for k, v in random_twin(seed=3).state_dict().items()}
    sd["AuxLogits.fc.weight"] = np.zeros((1000, 768), np.float32)
    jmodel = JI.FIDInceptionV3(with_logits=with_logits)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams, junused = JI.convert_fid_inception_state(sd, template=template)
    port, unused = PI.convert_fid_inception_state(
        sd, PI.FIDInceptionV3(with_logits=with_logits))
    assert unused == junused
    assert all("num_batches_tracked" not in k for k in unused)
    flat = {".".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    own = dict(port.named_parameters())
    assert own.keys() == flat.keys()
    for k, v in own.items():
        np.testing.assert_array_equal(v.detach().numpy(), flat[k], err_msg=k)
    assert ("fc.kernel" in own) == with_logits


def test_default_feature_fn_is_seeded_and_concatenates_logits():
    fn = PI.default_feature_fn(with_logits=True, device="cpu", seed=5)
    again = PI.default_feature_fn(with_logits=True, device="cpu", seed=5)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    a, b = fn(x), again(torch.from_numpy(x))
    assert a.shape == (2, 2048 + 1008) and a.dtype == torch.float32
    assert torch.equal(a, b)
    pool = PI.default_feature_fn(device="cpu", seed=5)(x)
    assert torch.equal(pool, a[:, :2048])
    bn = dict(fn.model.named_parameters())
    assert torch.equal(bn["Mixed_5b.branch1x1.bn.var"],
                       torch.ones(64))    # flax's BatchNorm init
