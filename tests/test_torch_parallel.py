"""The port's parallelism on the CPU: the TP and FSDP rules against the JAX
package's (``tests/test_mmdit_tp.py``, ``tests/test_fsdp.py``) under the
name map (``.`` read as ``/``), SD3-medium's TP parameter bytes on the
``meta`` device (``tests/test_tp_memory.py``), and one module-scoped spawn
of 4 gloo ranks (``tests/torch_parallel_ranks.py``, which imports no JAX)
whose results are held here against the replicated runs and JAX's:

* ring attention equals full attention at (T 48, 4 ranks) and (T 64, 2),
  its output T-sharded; its gradients (dq, dk, dv, for plain and for
  T-sharded inputs, each returned in its input's placements) equal
  autograd through the plain attention and ``jax.grad`` of JAX's ring on
  a CPU mesh of as many devices; the ring DiT equals the replicated one,
  and so do its train steps;
* the MMDiT TP + SP forward (data 2 x model 2) equals JAX's replicated
  forward on the same weights;
* the DiT TP + SP train step equals the replicated step (the losses, and
  Adam's moments, the record of the gradients); DP and FSDP over 4 data
  ranks equal it, FSDP bit for bit DP's, FSDP's per-rank state bytes about
  a quarter;
* DP Natural Inference equals the replicated run with no collective inside;
  DP FID activations equal the single-rank ones.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.models import mmdit as jm
from naturaldiffusion_tpu.parallel import fsdp_sharding as jax_fsdp_sharding
from naturaldiffusion_tpu.parallel import make_mesh as jax_make_mesh
from naturaldiffusion_tpu.parallel import mmdit_tp_sharding as jax_mmdit_tp
from naturaldiffusion_tpu.parallel import dit_tp_sharding as jax_dit_tp
from naturaldiffusion_tpu.models.dit import DiT as JDiT, DiTConfig as JDiTCfg
from naturaldiffusion_tpu.ops.ring_attention import ring_mha as jax_ring_mha
from naturaldiffusion_tpu_torch.models import mmdit as tm
from naturaldiffusion_tpu_torch.models.dit import DiT, DiTConfig
from naturaldiffusion_tpu_torch.parallel import (dit_tp_sharding,
                                                 fsdp_sharding, make_mesh,
                                                 mmdit_tp_sharding)
from naturaldiffusion_tpu_torch.parallel.dryrun import spawn_gloo
from naturaldiffusion_tpu_torch.parallel.shardings import (fsdp_spec,
                                                           flax_path)
from torch_port_util import jax_params

import torch_parallel_ranks as ranks

torch.set_num_threads(2)

MM_CFG = dict(sample_size=8, patch_size=2, in_channels=4, hidden_size=64,
              depth=2, num_heads=4, caption_projection_dim=64,
              joint_attention_dim=32, pooled_projection_dim=48,
              pos_embed_max_size=8)
# float32 on both sides, TP's row-parallel sums in other orders (~1e-7);
# JAX's dry-run tolerance
PAR_TOL = 2e-5


def _jax_spec_set(shardings):
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {"/".join(getattr(k, "key", str(k)) for k in kp): tuple(s.spec)
            for kp, s in flat if tuple(s.spec) != ()}


def _port_spec_set(shardings):
    return {flax_path(k): tuple(s.spec) for k, s in shardings.items()
            if tuple(s.spec) != ()}


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"data": 1, "model": 1}, device="cpu")


def _mmdit_inputs(b=4):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            np.linspace(0.1, 0.9, b).astype(np.float32),
            rng.standard_normal((b, 6, 32)).astype(np.float32),
            rng.standard_normal((b, 48)).astype(np.float32))


def test_mmdit_tp_rules_shard_what_jax_shards(mesh1):
    """The port's sharded set equals JAX's on the same model, spec for
    spec (``tests/test_mmdit_tp.py:37-60`` checks JAX's)."""
    x, t, ctx, pooled = _mmdit_inputs(1)
    jmod = jm.MMDiT(config=jm.MMDiTConfig(**MM_CFG))
    params = jax_params(jmod, x, t, ctx, pooled)
    want = _jax_spec_set(jax_mmdit_tp(params, jax_make_mesh(
        {"data": 4, "model": 2}, jax.devices()[:8])))
    got = _port_spec_set(mmdit_tp_sharding(
        tm.MMDiT(tm.MMDiTConfig(**MM_CFG), device="cpu"), mesh1))
    assert got == want and got
    for frag in ("attn_to_q/kernel", "attn_to_out_0/kernel",
                 "ff_net_0_proj/kernel", "norm1_linear/kernel"):
        assert any(frag in p for p in got), frag
    assert got["transformer_blocks_0/attn_to_q/kernel"] == (None, "model")
    assert got["transformer_blocks_0/attn_to_out_0/kernel"] == ("model",
                                                                None)


def test_dit_tp_rules_shard_what_jax_shards(mesh1):
    kw = dict(input_size=8, patch_size=2, in_channels=3, hidden_size=64,
              depth=2, num_heads=4, num_classes=10, learn_sigma=False,
              class_dropout_prob=0.0)
    jmod = JDiT(config=JDiTCfg(**kw))
    params = jax_params(jmod, np.zeros((1, 8, 8, 3), np.float32),
                        np.zeros(1, np.float32), np.zeros(1, np.int32))
    want = _jax_spec_set(jax_dit_tp(params, jax_make_mesh(
        {"data": 4, "model": 2}, jax.devices()[:8])))
    got = _port_spec_set(dit_tp_sharding(DiT(DiTConfig(**kw), device="cpu"),
                                         mesh1))
    # per block 8 (qkv, fc1, adaLN: kernel and bias; proj, fc2 kernels),
    # and the final layer's adaLN kernel and bias
    assert got == want and len(got) == 2 * 8 + 2


def test_wrong_family_warns(mesh1):
    model = DiT(DiTConfig(input_size=8, patch_size=2, in_channels=3,
                          hidden_size=32, depth=1, num_heads=2,
                          num_classes=10), device="cpu")
    with pytest.warns(UserWarning, match="zero MMDiT TP rules matched"):
        sh = mmdit_tp_sharding(model, mesh1)
    assert all(tuple(s.spec) == () for s in sh.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dit_tp_sharding(model, mesh1)


@pytest.mark.parametrize("shape,min_size", [
    ((256, 384), 2 ** 10), ((3, 3, 64, 128), 2 ** 10), ((129, 257), 2 ** 10),
    ((8, 8), 2 ** 10), ((), 2 ** 10), ((512, 40), 2 ** 14),
    ((3, 3, 128, 256), 2 ** 14)])
def test_fsdp_rule_matches_jax(shape, min_size):
    """``tests/test_fsdp.py:36``'s leaves and two more, over 8 data ranks:
    the port's spec is JAX's."""
    mesh = jax_make_mesh({"data": 8}, jax.devices()[:8])
    want = jax_fsdp_sharding({"x": jax.numpy.zeros(shape)}, mesh,
                             min_size=min_size)["x"].spec
    got = fsdp_spec(shape, 8, "data", min_size)
    assert P(*got) == want


def test_fsdp_sharding_keeps_the_tree(mesh1):
    tree = {"a": torch.zeros(64, 512), "b": [torch.zeros(3), 7]}
    sh = fsdp_sharding(tree, mesh1, min_size=16)
    assert tuple(sh["a"].spec) == (None, "data")
    assert tuple(sh["b"][0].spec) == () and sh["b"][1] == 7


def test_sd3_medium_tp_halves_parameter_bytes():
    """SD3-medium's trunk on the ``meta`` device (no weights made): the
    bytes a rank holds under ``mmdit_tp_sharding`` on model = 2, against
    the replicated 2.03 B parameters (``tests/test_tp_memory.py``)."""
    cfg = tm.SD3_MEDIUM
    model = tm.MMDiT(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())

    class Mesh2:                   # the mesh's names and sizes are all the
        mesh_dim_names = ("data", "model")    # rule and the count read

        @staticmethod
        def size(i):
            return (1, 2)[i]
    shard = mmdit_tp_sharding(model, Mesh2)
    local = 0
    for name, p in model.named_parameters():
        spec = tuple(shard[name].spec)
        local += p.numel() // (2 if "model" in spec else 1)
    assert 1.9e9 < total < 2.2e9
    assert 0.5 < local / total < 0.6, local / total


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    x, t, ctx, pooled = _mmdit_inputs(4)
    jmod = jm.MMDiT(config=jm.MMDiTConfig(**MM_CFG))
    params = jax_params(jmod, x[:1], t[:1], ctx[:1], pooled[:1], seed=5)
    np.save(d / "mmdit.npy", {"cfg": MM_CFG, "params": params,
                              "inputs": (x, t, ctx, pooled)},
            allow_pickle=True)
    spawn_gloo(ranks.run, 4, str(d))
    out = np.load(d / "results.npy", allow_pickle=True).item()
    with jax.enable_x64(False):
        out["jax_mmdit_forward"] = np.asarray(jmod.apply(
            {"params": params}, x, t, ctx, pooled))
        for name, axes, t_len in ranks.RING_CASES:
            n = int(np.prod(list(axes.values())))
            mesh = jax_make_mesh(axes, jax.devices()[:n])
            q, k, v, cot = (a.numpy() for a in ranks.ring_inputs(t_len))
            _, vjp = jax.vjp(lambda a, b, c: jax_ring_mha(
                a, b, c, mesh, sm_scale=0.25), q, k, v)
            out[f"jax_ring_{name}_grads"] = [np.asarray(g)
                                             for g in vjp(cot)]
    return out


@pytest.mark.parametrize("case", ["t48_ring4", "t64_ring2"])
def test_ring_equals_full_attention(results, case):
    assert results[f"ring_{case}_placement_is_t_shard"]
    assert results[f"ring_{case}_err"] < PAR_TOL
    assert results[f"ring_{case}_plain_err"] < PAR_TOL


@pytest.mark.parametrize("case", ["t48_ring4", "t64_ring2"])
def test_ring_gradient_equals_plain_attention_and_jax(results, case):
    assert results[f"ring_{case}_grad_err"] < PAR_TOL
    assert results[f"ring_{case}_dtensor_grad_placements"]
    assert results[f"ring_{case}_dtensor_grad_err"] < PAR_TOL
    for got, want in zip(results[f"ring_{case}_grads"],
                         results[f"jax_ring_{case}_grads"]):
        assert got.shape == want.shape and np.abs(want).max() > 0.1
        assert np.abs(got - want).max() < PAR_TOL


def test_ring_dit_equals_replicated(results):
    assert results["ring_dit_err"] < PAR_TOL


def test_ring_dit_train_step_equals_replicated(results):
    assert np.allclose(results["ring_train_loss"],
                       results["ring_train_rep_loss"], rtol=0, atol=1e-6)
    assert results["ring_train_state_err"] < 1e-5


def test_mmdit_tp_sp_forward_equals_jax(results):
    got, want = results["mmdit_tp_forward"], results["jax_mmdit_forward"]
    assert got.shape == want.shape == (4, 8, 8, 4)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() < PAR_TOL
    assert results["mmdit_batch_sharded"]
    assert results["mmdit_q_local_shape"] == (64, 32)   # columns over 2


def test_dit_tp_train_step_equals_replicated(results):
    assert np.allclose(results["tp_loss"], results["rep_loss"], rtol=0,
                       atol=1e-6)
    assert results["tp_state_err"] < 1e-5
    assert results["tp_qkv_local_shape"] == (64, 96)    # 192 columns / 2


def test_fsdp_equals_replicated_and_shards_the_state(results):
    for k in ("dp", "fsdp"):
        assert np.allclose(results[f"{k}_loss"], results["rep_loss"],
                           rtol=0, atol=1e-6), k
        assert results[f"{k}_state_err"] < 1e-5, k
    # FSDP is DP with the state in shards: the same numbers
    assert results["fsdp_vs_dp_err"] < 1e-6
    ratio = results["fsdp_bytes_full"] / results["fsdp_bytes_local"]
    assert 3.0 < ratio <= 4.0, ratio


def test_dp_sampling_equals_replicated_without_collectives(results):
    assert results["dp_ni_collectives"] == []
    assert results["dp_ni_local_rows"] == 4
    assert results["dp_ni_err"] < PAR_TOL
    assert results["dp_ni_plain_err"] < PAR_TOL


def test_dp_activations_equal_single_rank(results):
    assert results["dp_activations_shape"] == (30, 64)
    assert results["dp_activations_err"] < 1e-6
