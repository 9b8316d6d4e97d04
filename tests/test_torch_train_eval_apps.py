"""The port's apps that restore a training state, on the CPU at small
sizes, over a state that ``apps.train`` writes: ``quant_accuracy
--workdir`` (the EMA weights, the JAX app's report keys and ``w1_delta``),
``controllable_eval`` (its JSON rows) and ``roundtrip`` (its CSV columns,
the JAX app's, and the snapshot steps).  The JAX apps restore orbax
states, so the two packages cannot share a workdir: the numbers the apps
combine are held against the JAX package in the other port tests."""

import csv
import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu_torch.apps import (controllable_eval,
                                             quant_accuracy, roundtrip,
                                             toy_dataset)
from naturaldiffusion_tpu_torch.apps import train as tapp
from naturaldiffusion_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from naturaldiffusion_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)
MODEL = ["--nf", "16", "--ch-mult", "1,2", "--num-res-blocks", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A toy binary and a workdir with 3 iterations of training, snapshots
    at iterations 1 and 2."""
    root = tmp_path_factory.mktemp("trained")
    data, work = str(root / "toy"), str(root / "work")
    toy_dataset.main(["--out", data, "--n-train", "32", "--n-eval", "32"])
    assert tapp.main(["--workdir", work, "--data-dir", data, "--n-iters",
                      "3", "--batch", "4", "--snapshot-freq", "1",
                      "--no-snapshot-samples", "--device", "cpu"]
                     + MODEL) == 0
    return data, work


def test_quant_accuracy_workdir(trained, capsys):
    _, work = trained
    args = quant_accuracy.parse_args(["--workdir", work, "--batch", "2",
                                      "--steps", "2", "--device", "cpu",
                                      "--mode", "int8_static"] + MODEL)
    report = quant_accuracy.run(args)
    assert report["weights"] == "ema_step3"
    jax_keys = {"weights", "mode", "steps", "batch", "output_mean_abs",
                "mae_int8_vs_bf16", "max_int8_vs_bf16",
                "mae_bf16_vs_fp64oracle", "max_bf16_vs_fp64oracle",
                "mae_int8_vs_fp64oracle", "max_int8_vs_fp64oracle",
                "int8_extra_error_ratio", "finite", "w1_delta"}
    assert set(report) == jax_keys and report["finite"]
    assert set(report["w1_delta"]) == {"img_mean", "grad_delta",
                                       "ellipse_frac"}
    # the trajectories ran over the state's EMA weights
    model = NCSNpp(NCSNppConfig(nf=16, ch_mult=(1, 2), num_res_blocks=1),
                   device="cpu")
    assert quant_accuracy.load_ema(model, work) == "ema_step3"
    shadow = ckpt.load_state_dict(os.path.join(
        work, "checkpoints-meta"))["ema"]["shadow"]
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), shadow[k])
    bf16, _, _ = quant_accuracy.trajectories(args, model)
    args.workdir = None
    np.testing.assert_array_equal(
        quant_accuracy.trajectories(args, model)[0], bf16)
    empty = NCSNpp(NCSNppConfig(nf=16, ch_mult=(1, 2), num_res_blocks=1),
                   device="cpu")
    assert quant_accuracy.load_ema(empty, os.path.dirname(work)) == "random"


def test_controllable_eval(trained, tmp_path, capsys, monkeypatch):
    _, work = trained
    out = tmp_path / "ctrl"
    # the VP SDE cut from 1000 steps to 10 (the CPU's time)
    from naturaldiffusion_tpu_torch.sde import VPSDE
    monkeypatch.setattr(controllable_eval, "VPSDE", lambda: VPSDE(N=10))
    assert controllable_eval.main([
        "--workdir", work, "--outdir", str(out), "--num", "2", "--seeds",
        "1", "--predictor", "euler_maruyama", "--corrector",
        "none", "--device", "cpu"] + MODEL) == 0
    res = json.load(open(out / "controllable.json"))
    assert res["step"] == 3 and len(res["seeds"]) == 1
    row = res["seeds"][0]
    assert row["inpaint_finite"] and row["colorize_finite"]
    # the known pixels come back from the data, the luminance is kept
    assert row["inpaint_known_mse"] < 1e-6
    assert row["colorize_lum_mse"] < 1e-6
    for name in ("original", "masked_input", "gray_input", "inpaint_seed0",
                 "colorize_seed0"):
        assert (out / f"{name}.png").is_file()
    with pytest.raises(SystemExit, match="no restorable"):
        controllable_eval.main(["--workdir", str(tmp_path), "--outdir",
                                str(out), "--device", "cpu"] + MODEL)


def test_roundtrip(trained, tmp_path, capsys):
    data, work = trained
    out = tmp_path / "rt.csv"
    assert roundtrip.main([
        "--workdir", work, "--data-dir", data, "--features", "toy",
        "--num", "8", "--batch", "8", "--micro", "8", "--steps", "2",
        "--eval-n", "32", "--feat-batch", "16", "--out", str(out),
        "--grid-dir", str(tmp_path / "grids"), "--device", "cpu"]
        + MODEL) == 0
    rows = list(csv.DictReader(open(out)))
    assert [int(r["step"]) for r in rows] == [0, 1, 2]
    marg = ("img_mean", "grad_delta", "ellipse_frac")
    jax_cols = (["step", "features", "weights", "num", "ni_steps", "fid",
                 "fid_floor"] + [c for k in marg
                                 for c in (f"w1_{k}", f"w1_{k}_floor")]
                + ["finite", "img_per_sec"])
    assert list(rows[0]) == jax_cols
    assert all(r["finite"] == "True" and np.isfinite(float(r["fid"]))
               for r in rows)
    assert ckpt.latest_snapshot_step(work) == 2
    assert (tmp_path / "grids" / "step_2.png").is_file()
