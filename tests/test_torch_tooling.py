"""The port's tooling: the trace summary, the timer, the NFE counter, the
FLOP counter, and the apps ``bench_dit --flops-only/--count-flops/--trace``,
``bench_attention`` and ``bench_conv`` on the CPU, with the JSON keys of
the JAX apps they port."""

import gzip
import json
import os
import re
from pathlib import Path

import pytest
import torch

from naturaldiffusion_tpu_torch.apps import bench_attention, bench_conv
from naturaldiffusion_tpu_torch.apps import bench_dit
from naturaldiffusion_tpu_torch.utils import NFECounter, Timer, trace
from naturaldiffusion_tpu_torch.utils import flops as FL
from naturaldiffusion_tpu_torch.utils import trace_summary as TS
import torch_port_util  # noqa: F401  binds torch's CPU math first

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FLASH = ("void (anonymous namespace)::flash_kernel<__nv_bfloat16, 64, "
         "false>(__nv_bfloat16 const*, __nv_bfloat16 const*, long long, int)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64.2"


def _event(name, dur, cat="kernel", ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": 1.0, "dur": dur}


def _write_trace(path, events, gz=False):
    doc = {"schemaVersion": 1, "traceEvents": events}
    if gz:
        with gzip.open(path, "wt") as f:
            json.dump(doc, f)
    else:
        Path(path).write_text(json.dumps(doc))


def test_trace_summary_folds_kernel_families(tmp_path, capsys):
    """Device events only (kernels, copies, sets), folded into families;
    host operators and instant events are left out."""
    events = [
        _event(FLASH, 300.0), _event(FLASH, 100.0),
        _event(GEMM, 80.0),
        _event("Memcpy HtoD (Pageable -> Device)", 20.0, cat="gpu_memcpy"),
        _event("Memset (Device)", 0.0, cat="gpu_memset"),
        _event("aten::matmul", 5000.0, cat="cpu_op"),
        _event("cudaLaunchKernel", 900.0, cat="cuda_runtime"),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 2.0},
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    ]
    _write_trace(tmp_path / "host_1.100.pt.trace.json", events)
    total, fam = TS.summarize(str(tmp_path))
    assert total == 500.0
    assert fam == {"flash_kernel": 400.0,
                   "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
                       80.0,
                   "Memcpy HtoD": 20.0, "Memset": 0.0}
    # --bytes / --count: 4 launches of 2e8 bytes in 400 us -> 2000 GB/s
    assert TS.main([str(tmp_path), "--top", "2", "--family", "flash_kernel",
                    "--bytes", "2e8", "--count", "4"]) == 0
    out = capsys.readouterr().out
    assert "device total: 0.500 ms" in out
    assert re.search(r"0\.400 ms\s+80\.0%\s+flash_kernel", out)
    assert "Memcpy" not in out                     # --top 2
    assert "2000 GB/s achieved" in out and "H100" in out


def test_trace_summary_reads_the_newest_trace(tmp_path):
    old = tmp_path / "a" / "old.pt.trace.json"
    old.parent.mkdir()
    _write_trace(old, [_event(GEMM, 1.0)])
    new = tmp_path / "b.json.gz"
    _write_trace(new, [_event(FLASH, 2.0)], gz=True)
    os.utime(old, (1, 1))
    assert TS.summarize(str(tmp_path)) == (2.0, {"flash_kernel": 2.0})
    with pytest.raises(FileNotFoundError):
        TS.summarize(str(tmp_path / "a" / "none"))


def test_trace_writes_a_trace_the_summary_reads(tmp_path):
    with trace(str(tmp_path)):
        a = torch.randn(32, 32)
        (a @ a).sum()
    (path,) = tmp_path.glob("*.pt.trace.json")
    doc = json.loads(path.read_text())
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    assert TS.summarize(str(tmp_path)) == (0, {})  # no card, no device time


def test_timer_on_the_cpu_and_refusing_a_missing_card(monkeypatch):
    calls = []
    timer = Timer(iters=3, device="cpu")
    med = timer(lambda x: calls.append(x), 1)
    assert len(calls) == 4                         # one warm-up, 3 timed
    assert len(timer.times) == 3 and med == sorted(timer.times)[1]
    assert timer.once(lambda: None) >= 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Timer()


def test_nfe_counter():
    c = NFECounter(lambda x, t: x * t)
    assert c(2, 3) == 6 and c(1, 1) == 1 and c.nfe == 2
    c.reset()
    assert c.nfe == 0


@pytest.mark.parametrize("mods", [True, False])
def test_counted_flops_equal_the_shape_count(mods):
    """PyTorch's counter over one CPU CFG forward of the small DiT against
    ``flops_per_forward``: both count 2 FLOPs per multiply-add of the same
    products (patchify, the blocks' dense products and attention, the final
    linear; without ``mods`` also the embedders and adaLN) and neither
    counts elementwise work, so they agree exactly."""
    got = bench_dit.count_forward_flops(bench_dit.TOY, 1, 4.0, mods)
    assert got == bench_dit.flops_per_forward(bench_dit.TOY, 1, mods)


def test_flops_counted_refuses_a_tensor_off_the_cpu():
    with pytest.raises(ValueError, match="CPU"):
        FL.flops_counted(lambda a: a @ a, torch.empty(4, 4, device="meta"))
    x = torch.randn(8, 16)
    assert FL.flops_counted(lambda a: a @ a.T, x) == 2 * 8 * 16 * 8
    assert FL.H100_BF16_PEAK == 989e12


def test_bench_dit_flops_only_and_counted_with_a_trace(tmp_path, capsys,
                                                       monkeypatch):
    assert bench_dit.main(["--toy", "--flops-only", "--device", "cpu"]) == 0
    assert int(capsys.readouterr().out.strip()) == (
        bench_dit.flops_per_forward(bench_dit.TOY, 1, True))
    monkeypatch.setenv("NATDIFF_QUANT", "w8")
    assert bench_dit.main(["--toy", "--steps", "2", "--device", "cpu",
                           "--count-flops", "--trace", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["flops_source"] == "counted" and out["quant"] == "w8"
    assert out["flops_per_fwd"] == bench_dit.flops_per_forward(
        bench_dit.TOY, 1, True)
    assert list(tmp_path.glob("*.pt.trace.json"))


def _json_keys(jax_app: str) -> set[str]:
    """The keys of the JSON line a JAX app prints, read from its source."""
    src = (ROOT / "naturaldiffusion_tpu" / "apps" / jax_app).read_text()
    block = re.search(r"json\.dumps\(\{(.*?)\}\)", src, re.S).group(1)
    return set(re.findall(r'"(\w+)":', block))


def test_bench_attention_prints_the_jax_apps_keys(capsys):
    assert bench_attention.main(["--lengths", "128", "--heads", "2",
                                 "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    want = _json_keys("bench_attention.py")
    assert want == {"t", "b", "h", "d", "xla_ms", "flash_ms", "splash_ms",
                    "speedup", "flash_tflops", "splash_tflops"}
    assert want <= set(row)
    assert (row["t"], row["b"], row["h"], row["d"]) == (128, 2, 2, 64)
    assert all(row[k] > 0 for k in want)


def test_bench_conv_prints_the_jax_apps_keys(capsys):
    assert bench_conv.main(["--toy", "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    for k in ("shape", "xla_ms", "xla_tflops", "pallas_ms", "best_variant",
              "speedup"):
        assert k in row
    assert row["shape"] == [2, 8, 8, 128, 128]
    # every Pallas variant of the JAX app is served by one of the kernels
    src = (ROOT / "naturaldiffusion_tpu" / "apps" / "bench_conv.py").read_text()
    variants = set(re.search(r'cands = \[k for k in \(([^)]*)\)', src)
                   .group(1).replace('"', "").replace(" ", "").split(","))
    assert variants == {v for vs in row["serves"].values() for v in vs}
    assert row["best_variant"] in row["serves"]
    assert row["pallas_ms"] == row[f"{row['best_variant']}_ms"]


def test_bench_conv_model_prints_the_jax_apps_keys(capsys, monkeypatch):
    """``bench_conv --model``: one forward per route of the conv switch, the
    JAX app's labels (read from its source) and keys, on a small VE config
    on the CPU; the caller's switches restored after."""
    import dataclasses
    from naturaldiffusion_tpu_torch import configs
    name = "ve/celebahq_256_ncsnpp_continuous"
    cfg = configs.get_config(name)
    small = dataclasses.replace(cfg.model, image_size=16, nf=16,
                                ch_mult=(1, 2), num_res_blocks=1,
                                attn_resolutions=(8,))
    monkeypatch.setattr(configs, "get_config",
                        lambda n: dataclasses.replace(cfg, model=small))
    monkeypatch.setenv("NATDIFF_PALLAS_CONV", "1")
    monkeypatch.delenv("NATDIFF_CONV_TILED", raising=False)
    assert bench_conv.main(["--model", name, "--runs", "1", "--batch", "1",
                            "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    src = (ROOT / "naturaldiffusion_tpu" / "apps" / "bench_conv.py").read_text()
    labels = re.findall(r'\("(\w+)", "[012]", (?:"\w+"|None)\)', src)
    assert labels == [m[0] for m in bench_conv.MODEL_MODES]
    assert (row["model"], row["batch"], row["reps"]) == (name, 1, 4)
    for label in labels:
        assert row[f"{label}_ms"] > 0 and row[f"{label}_img_s"] > 0
        assert f"{label}_error" not in row
    assert os.environ["NATDIFF_PALLAS_CONV"] == "1"
    assert "NATDIFF_CONV_TILED" not in os.environ


def test_tool_apps_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_attention.main(["--lengths", "64"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_conv.main(["--toy"])



def _k1_trace(path, n):
    """A trace of ``n`` device launches of K1's kernel and one other."""
    _write_trace(path, [_event("void weighted_sum_kernel<4>(float*)", 1.0)
                        for _ in range(n)] + [_event(GEMM, 1.0)])


def test_chip_smoke_profiles_again_a_trace_that_lost_records(tmp_path):
    """A trace can lose device records, never add one: the bench check
    profiles the dispatch again while a trace counts fewer launches than
    the graph holds (the newest trace is read, ``rec`` takes its numbers),
    stops at an exact or an excess count, and hands back the last count
    after BENCH_TRACE_TRIES traces."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.BENCH_TRACE_TRIES == 3

    class FakeBench:
        def __init__(self, n):
            self.n, self.seeds = n, []

        def profile_dispatch(self, b, logdir, seed, chunks):
            self.seeds.append(seed)
            _k1_trace(Path(logdir) / f"t{seed}.pt.trace.json", self.n)
            return {"busy": 0.5, "chunks": chunks}

    want = {"fused_weighted_sum": 20, "conv3x3_int8": 0}
    for first, again, traced, seeds in [
            (19, 20, 20, [100]),          # short, then whole
            (20, 20, 20, []),             # whole at once
            (21, 20, 21, []),             # an excess is no lost record
            (19, 18, 18, [100, 101])]:    # short in every trace
        d = tmp_path / f"{first}_{again}_{len(seeds)}"
        d.mkdir()
        _k1_trace(d / "a.pt.trace.json", first)
        os.utime(d / "a.pt.trace.json", (1, 1))
        B = FakeBench(again)
        rec = {"form": "fused_bf16", "traced_dispatch": {}, "busy": 0.9}
        got = cs.whole_trace_launches(B, None, str(d), rec, want)
        assert got["fused_weighted_sum"] == traced
        assert got["conv3x3_int8"] == 0 and B.seeds == seeds
        assert rec["traced_dispatch"]["tries"] == len(seeds) + 1
        assert rec["busy"] == (0.5 if seeds else 0.9)
