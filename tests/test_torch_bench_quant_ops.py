"""The port's W8A8 micro-bench (``apps.bench_quant_ops``) on the CPU at
tiny shapes: every row's output against the JAX package's int8 ops
(``conv3x3_int8``, ``conv1x1_int8``, the s8 products) and bf16 ops on the
same inputs, under the rules of ``tests/test_torch_quant.py``; its JSON
keys and shapes equal the JAX app's; its CLI prints a line a shape."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.apps import bench_quant_ops as jb
from naturaldiffusion_tpu.ops import quant as jq
from naturaldiffusion_tpu.ops.conv3x3 import conv3x3_xla
from naturaldiffusion_tpu_torch.apps import bench_quant_ops as pb
from naturaldiffusion_tpu_torch.ops import quant as tq

# the dequant's two f32 roundings against XLA's FMA contraction: one bf16
# ulp of the output (tests/test_torch_quant.py:ULPS)
BF16_ULP = 2.0 ** -8
# a bf16 conv or product of f32 sums in another order: a bf16 rounding of
# each side, against the largest output
BF16_OP_TOL = 2 * 2.0 ** -8


def _pair(a):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(t):
    return t.detach().float().numpy().astype(np.float64)


def _within_rounding(got, want):
    got, want = _np(got), np.asarray(want, np.float64)
    lim = BF16_ULP * np.maximum(np.abs(want), 1e-30)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= lim + 1e-37).all()


def _within_op(got, want):
    got, want = _np(got), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_OP_TOL * np.abs(want).max()


def _inputs(shape, nin, seed=5):
    rng = np.random.default_rng(seed)
    bsz, hh, ww, cin, cout = shape
    x = np.tanh(rng.standard_normal((bsz, hh, ww, cin))) * 3.0
    w = rng.standard_normal((cin, cout) if nin else (3, 3, cin, cout)) * 0.03
    b = 0.1 * rng.standard_normal(cout)
    return _pair(x), _pair(w), _pair(b)


def test_conv_rows_against_jax():
    (xt, xj), (wt, wj), (bt, bj) = _inputs((2, 6, 8, 128, 128), nin=False)
    rows = pb.conv_rows(xt, wt, bt)
    assert list(rows) == ["bf16", "int8_dyn", "int8_pt", "int8_st",
                          "int8_raw"]
    got = {k: f() for k, f in rows.items()}
    assert all(g.shape == (2, 6, 8, 128) and g.dtype == torch.bfloat16
               for g in got.values())
    _within_op(got["bf16"], np.asarray(conv3x3_xla(xj, wj, bj), np.float64))
    _within_rounding(got["int8_dyn"], jq.conv3x3_int8(xj, wj, bj))
    _within_rounding(got["int8_pt"],
                     jq.conv3x3_int8(xj, wj, bj, per_sample=False))
    _within_rounding(got["int8_st"],
                     jq.conv3x3_int8(xj, wj, bj, act_amax=6.0))
    # the raw product: JAX's s8 conv of the same int8 operands, int32,
    # taken to f32 and bf16 as the kernel's epilogue takes it
    x_i8, _ = jq.quantize_act(xj)
    w_i8, _ = jq.quantize_weight(wj)
    acc = jax.lax.conv_general_dilated(
        x_i8, w_i8, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = torch.from_numpy(np.array(acc)).float().to(torch.bfloat16)
    assert torch.equal(got["int8_raw"], want)


def test_nin_rows_against_jax():
    (xt, xj), (wt, wj), (bt, bj) = _inputs((2, 4, 4, 128, 256), nin=True)
    got = {k: f() for k, f in pb.nin_rows(xt, wt, bt).items()}
    assert list(got) == ["bf16", "int8_dyn", "int8_st"]
    _within_op(got["bf16"], np.asarray(
        jnp.einsum("...c,cd->...d", xj, wj) + bj, np.float64))
    _within_rounding(got["int8_dyn"], jq.conv1x1_int8(xj, wj, bj))
    _within_rounding(got["int8_st"],
                     jq.conv1x1_int8(xj, wj, bj, act_amax=6.0))


def test_gemm_rows_exact_int32():
    rows = pb.gemm_rows(64, torch.device("cpu"))
    bf, raw = rows["bf16"](), rows["int8_raw"]()
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((64, 64), generator=gen).to(torch.bfloat16)
    b = torch.randn((64, 64), generator=gen).to(torch.bfloat16)
    a8, b8 = (np.clip(np.round(_np(t) * 20), -127, 127).astype(np.int8)
              for t in (a, b))
    want = jax.lax.dot_general(jnp.asarray(a8), jnp.asarray(b8),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), np.asarray(want))
    _within_op(bf, _np(a) @ _np(b))


def test_shapes_equal_jax():
    assert pb.SHAPES == jb.SHAPES and pb.NIN_SHAPES == jb.NIN_SHAPES


@pytest.mark.parametrize("kind", ["conv", "nin", "gemm"])
def test_json_keys_equal_jax(kind):
    if kind == "gemm":
        got = pb.bench_gemm(32, reps=1, runs=1, device="cpu")
        want = jb.bench_gemm(32, reps=1, runs=1)
    else:
        shape = (2, 4, 4, 128, 128)
        pfn, jfn = ((pb.bench_shape, jb.bench_shape) if kind == "conv"
                    else (pb.bench_nin, jb.bench_nin))
        got = pfn(shape, reps=1, runs=1, device="cpu")
        want = jfn(shape, reps=1, runs=1)
    assert not [k for k in got if k.endswith("_error")], got
    assert sorted(got) == sorted(want) and got["shape"] == want["shape"]
    assert all(got[k] > 0 for k in got if k.endswith(("_ms", "_tflops")))


def test_cli_prints_a_line_a_shape(monkeypatch, capsys):
    monkeypatch.setattr(pb, "SHAPES", [(1, 4, 4, 128, 128)])
    monkeypatch.setattr(pb, "NIN_SHAPES", [(1, 4, 4, 128, 128)])
    monkeypatch.setattr(pb, "GEMM_N", 32)
    assert pb.main(["--reps", "1", "--runs", "1", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["shape"][0] for ln in lines] == ["gemm", 1, "nin"]
    assert pb.main(["--reps", "1", "--runs", "1", "--device", "cpu",
                    "--skip-gemm"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 2
    assert pb.main(["--gemm-only", "--device", "cpu", "--runs", "1"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1
