"""The port's training apps on the CPU at small sizes: ``toy_dataset``'s
bytes against the JAX app's; ``train`` for 3 iterations on a toy binary
(metrics, a snapshot and its EMA sample grid, then a run cut after 2
iterations and resumed from ``checkpoints-meta`` equal bit for bit to the
uninterrupted one), its eval mode, ``--fsdp`` equal to the run without it; ``bench_train``'s
JSON line with the JAX app's keys."""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu_torch.apps import bench_train, toy_dataset
from naturaldiffusion_tpu_torch.apps import train as tapp
from naturaldiffusion_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)
SMALL = ["--nf", "16", "--ch-mult", "1,2", "--num-res-blocks", "1",
         "--device", "cpu", "--batch", "4", "--log-freq", "1"]


def test_toy_dataset_bytes_match_jax(tmp_path, capsys):
    from naturaldiffusion_tpu.apps import toy_dataset as jtoy
    for mod, d in ((toy_dataset, "port"), (jtoy, "jax")):
        assert mod.main(["--out", str(tmp_path / d), "--n-train", "30",
                         "--n-eval", "10", "--chunk", "7"]) == 0
    for name in ("data_batch_1.bin", "test_batch.bin"):
        a = (tmp_path / "port" / name).read_bytes()
        assert a == (tmp_path / "jax" / name).read_bytes()
    assert len((tmp_path / "port" / "test_batch.bin").read_bytes()) \
        == 10 * 3073
    params = toy_dataset.draw_params(8)
    imgs = toy_dataset.render(params, 0, 8)
    stats = toy_dataset.summary_stats(imgs / 255.0)
    assert set(stats) == {"img_mean", "grad_delta", "ellipse_frac"}
    assert toy_dataset.wasserstein1(stats["img_mean"],
                                    stats["img_mean"]) == 0.0


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    toy_dataset.main(["--out", str(d), "--n-train", "64", "--n-eval", "64"])
    return str(d)


def _state(workdir):
    return ckpt.load_state_dict(os.path.join(workdir, "checkpoints-meta"))


def test_train_snapshot_and_exact_resume(toy, tmp_path, capsys):
    common = SMALL + ["--data-dir", toy, "--snapshot-freq", "2",
                      "--preemption-freq", "1", "--sample-steps", "2"]
    whole = tmp_path / "whole"
    assert tapp.main(["--workdir", str(whole), "--n-iters", "3"]
                     + common) == 0
    assert os.path.isfile(whole / "checkpoints" / "checkpoint_2" / "state.pt")
    assert os.path.isfile(whole / "samples" / "iter_2.png")
    recs = [json.loads(line) for line in open(whole / "metrics.jsonl")]
    assert {r["tag"] for r in recs} == {"training_loss", "img_per_sec"}
    assert [r["step"] for r in recs if r["tag"] == "training_loss"] \
        == [0, 1, 2]
    assert all(np.isfinite(r["value"]) for r in recs)
    assert ckpt.latest_snapshot_step(str(whole)) == 2

    cut = tmp_path / "cut"
    assert tapp.main(["--workdir", str(cut), "--n-iters", "2"]
                     + common) == 0
    assert _state(str(cut))["step"] == 2
    assert tapp.main(["--workdir", str(cut), "--n-iters", "3"]
                     + common) == 0
    assert "start step 2" in capsys.readouterr().out
    a, b = _state(str(whole)), _state(str(cut))
    assert a["step"] == b["step"] == 3
    for part in ("params",):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), k
    for k in a["ema"]["shadow"]:
        assert torch.equal(a["ema"]["shadow"][k], b["ema"]["shadow"][k])
        assert torch.equal(a["opt_state"]["nu"][k], b["opt_state"]["nu"][k])


def test_train_bf16_and_eval(toy, tmp_path, capsys):
    wd = str(tmp_path / "bf16")
    assert tapp.main(["--workdir", wd, "--n-iters", "2", "--bf16",
                      "--data-dir", toy, "--no-snapshot-samples"]
                     + SMALL) == 0
    st = _state(wd)
    assert all(v.dtype == torch.float32 for v in st["params"].values())
    cfg, mode = tapp.parse(["--workdir", wd, "--mode", "eval",
                            "--data-dir", toy] + SMALL)
    assert mode == "eval"
    out = tapp.evaluate(cfg)
    assert np.isfinite(out["eval_loss"]) and "bpd" not in out
    assert "eval loss (EMA, 16 batches)" in capsys.readouterr().out


def test_train_refuses_fsdp(toy, tmp_path):
    """``--fsdp`` is ported: on the 1-rank CPU mesh two steps with it leave
    the state of two steps without it (the 4-rank check against the
    replicated step is ``tests/test_torch_parallel.py``'s)."""
    states = {}
    for flag in ([], ["--fsdp"]):
        wd = str(tmp_path / ("fsdp" if flag else "plain"))
        assert tapp.main(["--workdir", wd, "--n-iters", "2",
                          "--data-dir", toy, "--sample-steps", "2"] + flag
                         + SMALL) == 0
        states[bool(flag)] = _state(wd)
    want, got = states[False], states[True]
    for a, b in ((got["params"], want["params"]),
                 (got["opt_state"]["mu"], want["opt_state"]["mu"]),
                 (got["ema"]["shadow"], want["ema"]["shadow"])):
        for k, v in b.items():
            torch.testing.assert_close(a[k], v, rtol=0, atol=0)


def test_train_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(["--workdir", str(tmp_path), "--n-iters", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_train.main(["--batch", "1"])


def test_bench_train_json(capsys):
    assert bench_train.main(["--batch", "2", "--chain", "2", "--nf", "16",
                             "--runs", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_keys = {"model", "batch", "chain", "remat", "bf16", "micro",
                "step_ms", "img_per_sec", "flops_per_step", "flops_source",
                "tflops", "mfu_vs_f32_peak", "mfu_vs_bf16_peak"}
    assert jax_keys <= set(rec)
    assert rec["batch"] == 2 and rec["chain"] == 2
    for k in ("step_ms", "img_per_sec", "flops_per_step", "tflops",
              "mfu_vs_f32_peak", "mfu_vs_bf16_peak"):
        assert np.isfinite(rec[k]) and rec[k] > 0, (k, rec)
    # the count scales with the batch: one sample's step, times 2
    assert rec["flops_per_step"] == 2 * bench_train.count_flops(
        bench_train.argparse.Namespace(batch=1, nf=16, remat=False,
                                       bf16=False, micro=0))


def test_bench_train_micro_and_flops_only(capsys):
    assert bench_train.main(["--batch", "2", "--chain", "1", "--nf", "16",
                             "--runs", "1", "--device", "cpu", "--micro",
                             "1", "--flops", "5e9"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["micro"] == 1 and rec["flops_per_step"] == 5e9
    assert bench_train.main(["--flops-only", "--batch", "3", "--nf",
                             "16"]) == 0
    assert float(capsys.readouterr().out.strip()) > 0
