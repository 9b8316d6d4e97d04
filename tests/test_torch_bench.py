"""The port bench (``naturaldiffusion_tpu_torch.apps.bench``) end to end on
the CPU at toy scale: the JSON contract of the repository's ``bench.py``
(``tests/test_bench_headline.py``), what it refuses, and its samples
against the engine fed the same inputs."""

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
    for k in ("BENCH_QUANT", "BENCH_MODS", "BENCH_GRAPH", "BENCH_DEVICE"):
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
    assert rec["form"] == "fused_bf16" and rec["graph"] is False
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
    ({"BENCH_QUANT": "int8_static"}, NotImplementedError, "int8"),
    ({"BENCH_QUANT": "int8"}, NotImplementedError, "int8"),
    ({"BENCH_MODS": "1"}, NotImplementedError, "ncsnpp_schedule_biases"),
    ({"BENCH_GRAPH": "1"}, ValueError, "CUDA graph"),
    ({"BENCH_MICRO": "3"}, ValueError, "must divide"),
])
def test_bench_refuses(toy_env, env, err, match):
    for k, v in env.items():
        toy_env.setenv(k, v)
    with pytest.raises(err, match=match):
        bench.main(["--device", "cpu"])


def test_bench_refuses_a_missing_card(toy_env):
    toy_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    toy_env.setenv("BENCH_DEVICE", "cpu")        # the env's way onto the CPU
    with pytest.raises(NotImplementedError, match="int8"):
        toy_env.setenv("BENCH_QUANT", "int8_static")
        bench.main([])


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
