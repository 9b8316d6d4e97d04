"""Shared helpers of the ``test_torch_*`` files: random weights for the JAX
NCSN++ made with numpy, so the same weights go through both packages.

Every ``test_torch_*`` file imports this module before it runs anything, and
importing it binds torch's CPU math first: in a pytest-xdist worker whose
first test ran a JAX interpret kernel (``group_norm_pallas(interpret=True)``)
before torch's first SiLU, the port's plain GroupNorm on the same inputs read
up to 3.2e-5 off in about one run of its file in 15.  A torch call first, or
``LD_BIND_NOW=1`` (every symbol bound when its library loads), made every run
byte-identical."""

from __future__ import annotations

import math

import numpy as np
import torch

from naturaldiffusion_tpu_torch.ops.group_norm import fused_group_norm

fused_group_norm(torch.ones(2, 2, 2, 8), torch.ones(8), torch.zeros(8), 2,
                 act="silu", extra_bias=torch.ones(1, 8))

# the fused-resblock test config (tests/test_conv3x3.py), plus attention at
# 4x4 so AttnBlockpp is on the path
SMALL = dict(nf=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
             image_size=8)


def random_flax_params(shapes, rng: np.random.Generator) -> dict:
    """A param tree of ``shapes`` (a flax ``eval_shape`` tree) as nested
    dicts of float32 numpy arrays, every leaf non-trivial: kernels scaled by
    1/sqrt(fan_in) so activations stay O(1) (the JAX init zeroes the
    residual and head convs, which would hide a wrong conv), GroupNorm
    scales near 1, biases small."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = random_flax_params(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k in ("bias", "b"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = math.prod(shape[:-1])
            a = rng.standard_normal(shape) / math.sqrt(fan_in)
        out[k] = a.astype(np.float32)
    return out


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_params(module, *args, seed: int = 0) -> dict:
    """Random weights (:func:`random_flax_params`, from ``seed``) for every
    leaf of the JAX ``module``'s param tree at inputs like ``args`` (traced
    by shape only; float32 under ``jax.enable_x64(False)``)."""
    import jax
    with jax.enable_x64(False):
        shapes = jax.eval_shape(
            lambda k: module.init(k, *args)["params"], jax.random.PRNGKey(0))
    return random_flax_params(shapes, np.random.default_rng(seed))


def torch_state_dict(template, path_map, rng: np.random.Generator) -> dict:
    """A torch state dict in the reference's names and layouts for every
    leaf of a flax param tree: random values, each transposed from the
    flax layout by the inverse of JAX's transform, and one buffer no
    parameter reads (``sigmas``)."""
    import jax

    from naturaldiffusion_tpu.models import convert as jconvert
    sd = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(template)[0]:
        path = tuple(k.key for k in kp)
        tleaf, _ = jconvert._torch_leaf_and_transform(path)
        key = path_map(path[:-1]) + "." + tleaf
        shape = np.asarray(leaf).shape
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        a = rng.standard_normal(shape) / np.sqrt(fan_in)
        if path[-1] == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        a = a.astype(np.float32)
        if path[-1] in ("kernel", "weight") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel":
            a = a.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    sd["sigmas"] = torch.ones(3)
    return sd
