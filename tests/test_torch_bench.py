"""The port bench (``naturaldiffusion_tpu_torch.apps.bench``) end to end on
the CPU at toy scale: the JSON contract of the repository's ``bench.py``
(``tests/test_bench_headline.py``), its forms (``BENCH_QUANT``,
``BENCH_MODS``, ``NATDIFF_PALLAS_CONV``), what it refuses, and its samples
against the engine fed the same inputs."""

import os

import json

import pytest
import torch

from naturaldiffusion_tpu_torch.apps import bench
from naturaldiffusion_tpu_torch.engine import natural_inference
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

TOY = dict(BENCH_TOTAL="4", BENCH_MICRO="2", BENCH_STEPS="2")


@pytest.fixture
def toy_env(monkeypatch):
    for k in ("BENCH_QUANT", "BENCH_MODS", "BENCH_GRAPH", "BENCH_DEVICE",
              "NATDIFF_PALLAS_CONV", "NATDIFF_QUANT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TOY.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def test_bench_main_toy(toy_env, capsys, tmp_path):
    assert bench.main(["--device", "cpu", "--trace", str(tmp_path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "cifar10_ni10_img_per_sec_per_chip"
    assert rec["unit"] == "img/s"
    assert rec["value"] > 0 and "vs_baseline" not in rec
    assert rec["flops_per_img_step"] > 0
    assert rec["flops_source"].startswith("counted")
    assert rec["micro_batch"] == 2 and rec["total_batch"] == 4
    assert rec["steps"] == 2
    # bench.py's form on the CPU: unfused convs (JAX's default "0"), no
    # int8 (bench.py takes int8_static on an accelerator only)
    assert rec["form"] == "unfused_bf16" and rec["graph"] is False
    assert (rec["conv"], rec["quant"], rec["mods"]) == ("0", "", False)
    assert rec["mfu_vs_int8_peak"] is None
    assert rec["card"] == "cpu" and rec["mfu"] is None
    # the CPU has no device events: the profiled dispatch reads 0 busy
    assert rec["busy"] == 0.0 and rec["traced_dispatch"]["wall_s"] > 0
    assert len(rec["dispatch_s"]) == 5


def test_flops_only_counts_one_image(capsys):
    """The count equals PyTorch's counter over one forward, at the size of
    a full-width NCSN++ (tens of GFLOP an image)."""
    assert bench.main(["--flops-only"]) == 0
    flops = int(capsys.readouterr().out.strip().splitlines()[-1])
    assert flops == bench.count_flops_per_image()
    assert 1e10 < flops < 1e11


@pytest.mark.parametrize("env,err,match", [
    ({"BENCH_QUANT": "int4"}, ValueError, "BENCH_QUANT"),
    ({"BENCH_QUANT": "w8"}, ValueError, "BENCH_QUANT"),
    ({"NATDIFF_PALLAS_CONV": "3"}, ValueError, "NATDIFF_PALLAS_CONV"),
    ({"BENCH_GRAPH": "1"}, ValueError, "CUDA graph"),
    ({"BENCH_MICRO": "3"}, ValueError, "must divide"),
])
def test_bench_refuses(toy_env, env, err, match):
    for k, v in env.items():
        toy_env.setenv(k, v)
    with pytest.raises(err, match=match):
        bench.main(["--device", "cpu"])


@pytest.mark.parametrize("quant", [None, "", "int8", "int8_all",
                                   "int8_static", "int8_all_static"])
@pytest.mark.parametrize("mods", [None, "0", "1"])
def test_bench_settings(toy_env, quant, mods):
    """Every ``BENCH_QUANT`` and ``BENCH_MODS`` value parses; an unset
    ``BENCH_QUANT`` is left to ``main`` (int8_static on a card, "" on the
    CPU), and ``NATDIFF_PALLAS_CONV`` defaults to JAX's ``"0"``."""
    for k, v in (("BENCH_QUANT", quant), ("BENCH_MODS", mods)):
        if v is not None:
            toy_env.setenv(k, v)
    cfg = bench.settings()
    assert cfg["quant"] == quant and cfg["mods"] == (mods == "1")
    assert cfg["conv"] == "0"
    toy_env.setenv("NATDIFF_PALLAS_CONV", "2")
    assert bench.settings()["conv"] == "2"
    assert bench.form_name("0", quant or "") == f"unfused_{quant or 'bf16'}"
    assert bench.form_name("2", "") == "fused_bf16"


def test_bench_refuses_a_missing_card(toy_env, capsys):
    """Without a card the bench raises unless asked for the CPU; there
    (``BENCH_DEVICE``) it runs a quantized, hoisted form: one 2-image chunk
    of one step under ``int8_static`` and ``BENCH_MODS=1``, the int8 convs
    through their plain versions."""
    toy_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    for k, v in (("BENCH_DEVICE", "cpu"), ("BENCH_QUANT", "int8_static"),
                 ("BENCH_MODS", "1"), ("BENCH_TOTAL", "2"),
                 ("BENCH_STEPS", "1")):
        toy_env.setenv(k, v)
    assert bench.main([]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["form"] == "unfused_int8_static" and rec["mods"] is True
    assert rec["quant"] == "int8_static" and rec["conv"] == "0"
    assert rec["value"] > 0 and rec["card"] == "cpu"
    assert "NATDIFF_QUANT" not in os.environ       # restored after the run


def test_bench_form_env_is_scoped(toy_env):
    """The form's variables hold inside a forward only: the int8 convs run
    there (their plain versions on the CPU), and the caller's environment
    is unchanged after."""
    from naturaldiffusion_tpu_torch.ops import quant as Q
    toy_env.setenv("NATDIFF_QUANT", "w8")
    seen = []
    orig = Q.conv3x3_int8

    def rec(*a, **k):
        seen.append((os.environ["NATDIFF_QUANT"], k.get("act_amax")))
        return orig(*a, **k)

    toy_env.setattr(Q, "conv3x3_int8", rec)
    b = bench.Bench(micro=1, total=1, steps=1, device="cpu", graph=False,
                    conv="0", quant="int8", mods=True)
    assert b.form == "unfused_int8" and "step_inputs" in b.kwargs
    assert sorted(b.mods) == sorted(
        k for k, m in b.net.layers.items() if hasattr(m, "Dense_0"))
    out = b.chunk(0, torch.Generator().manual_seed(3))
    assert torch.isfinite(out).all()
    assert len(seen) == 88 and set(seen) == {("int8", None)}
    assert os.environ["NATDIFF_QUANT"] == "w8"
    assert os.environ.get("NATDIFF_PALLAS_CONV") is None


def test_chunk_equals_natural_inference():
    """A micro-batch of the bench is ``natural_inference`` over the bench's
    model and schedule, its noises drawn from the dispatch's generator."""
    b = bench.Bench(micro=2, total=4, steps=2, device="cpu", graph=False)
    got = b.chunk(1, torch.Generator().manual_seed(7))
    noises = torch.randn((2, 2, 32, 32, 3),
                         generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = natural_inference(b.eps_fn, b.sched, b.zs[1], noises=noises,
                                 prediction_type="eps",
                                 model_dtype=torch.bfloat16)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a dispatch is the sum over both chunks, the same for the same seed
    assert b.dispatch(11) == b.dispatch(11)
    # one chunk's dispatch is that chunk's sum, by the eager loop too
    assert b.dispatch(11, 1) == float(
        b.eager_chunk(0, torch.Generator().manual_seed(11)).sum())


def test_graph_needs_a_card():
    from naturaldiffusion_tpu_torch.coeffs import registry
    from naturaldiffusion_tpu_torch.engine import NISchedule
    from naturaldiffusion_tpu_torch.engine.graph import GraphedNI
    sched = NISchedule.from_matrix(registry.derive("ddpm", 2), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        GraphedNI(lambda z, t: z, sched, (1, 4, 4, 3))
