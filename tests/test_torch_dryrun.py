"""The port's multi-rank dry run (``parallel.dryrun``, the twin of the JAX
package's ``__graft_entry__.py:dryrun_multichip``) runs to its end on 4
spawned gloo ranks, every check inside it (each against its replicated
run, at JAX's tolerances) passing; and the numbers it returns are those
checks'."""

import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu_torch.parallel.dryrun import (_mesh_axes,
                                                        dryrun_multichip)


def test_dryrun_multichip_4_runs_to_its_end():
    res = dryrun_multichip(4, device="cpu")
    for k in ("fsdp_err", "mmdit_err", "dp_ni_err", "dp_hoisted_err",
              "mmdit_ni_err", "ring_err"):
        assert res[k] < 2e-5, (k, res[k])
    assert res["dp_fused_conv_err"] < 5e-5
    assert 0 < res["dp_int8_rel"] < 5e-2
    assert abs(res["bf16_loss"] - res["f32_loss"]) \
        < 0.05 * abs(res["f32_loss"]) + 1e-3


@pytest.mark.parametrize("n,axes", [(4, {"data": 2, "model": 2}),
                                    (1, {"data": 1, "model": 1}),
                                    (3, {"data": 3, "model": 1})])
def test_mesh_axes_as_jax_lays_them_out(n, axes):
    assert _mesh_axes(n) == axes


def test_card_dry_run_is_one_rank():
    with pytest.raises(ValueError, match="1 rank"):
        dryrun_multichip(2, device="meta")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
@pytest.mark.parametrize("argv", [None, []])
def test_default_is_the_card_and_raises_without_one(argv):
    """Like every entry point, the dry run and its CLI default to the
    card (one rank) and refuse to fall back to the CPU quietly."""
    from naturaldiffusion_tpu_torch.parallel import dryrun
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if argv is None:
            dryrun_multichip()
        else:
            dryrun.main(argv)
