"""The port's spans (``utils/profiling.py``: ``span``, ``set_spans``,
``span_record``, ``clear_spans``): off they are one shared no-op; on they
record host seconds, the parent and the outermost span's number, nest, keep
the newest SPAN_KEEP runs of a name, land in a ``torch.profiler`` trace as
``user_annotation`` events, and change no result.  Every test leaves the
spans as it found them (``spans`` fixture): xdist runs many tests in one
process.  The tests named ``..._on_the_card`` skip without a CUDA device
and import no JAX, so that on the card
``python -m pytest tests/test_torch_spans.py --noconftest -k on_the_card``
runs them."""

import json

import pytest
import torch

from naturaldiffusion_tpu_torch.coeffs import registry
from naturaldiffusion_tpu_torch.engine import NISchedule, natural_inference
from naturaldiffusion_tpu_torch.utils import (clear_spans, set_spans, span,
                                              span_record, trace)
from naturaldiffusion_tpu_torch.utils import profiling
import torch_port_util  # noqa: F401  (binds torch's CPU math first)


@pytest.fixture
def spans():
    """Spans off and nothing recorded; afterwards the state found."""
    was_on = set_spans(False)
    clear_spans()
    yield
    clear_spans()
    set_spans(was_on)


def test_off_records_nothing_and_is_the_shared_noop(spans):
    a, b = span("a"), span("b")
    assert a is b
    with a:
        with span("c"):
            pass
    assert span_record() == {}


def test_on_records_host_parent_outer_nests_keeps_newest_and_clears(spans):
    set_spans(True)
    with span("outer"):
        with span("inner"):
            sum(range(1000))
        with span("inner"):
            pass
    with span("outer"):
        pass
    with span("inner"):
        pass
    rec = span_record()
    assert set(rec) == {"outer", "inner"}
    o1, o2 = rec["outer"]
    i1, i2, i3 = rec["inner"]
    assert o1.parent is None and o2.parent is None and i3.parent is None
    assert i1.parent == i2.parent == "outer"
    assert i1.outer == i2.outer == o1.outer
    assert len({o1.outer, o2.outer, i3.outer}) == 3
    assert o1.host_s >= i1.host_s + i2.host_s > 0
    assert all(r.device_s is None for r in rec["outer"] + rec["inner"])
    for _ in range(profiling.SPAN_KEEP + 5):
        with span("many"):
            pass
    many = span_record()["many"]
    assert len(many) == profiling.SPAN_KEEP
    # the newest kept: their outermost numbers run on to the last one's
    assert many[-1].outer - many[0].outer == profiling.SPAN_KEEP - 1
    clear_spans()
    assert span_record() == {}


def test_cpu_profile_exports_spans_as_user_annotations(spans, tmp_path):
    set_spans(True)
    x = torch.ones(4, 4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                y = x @ x
    assert torch.equal(y, x @ x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    got = {e["name"]: e for e in events if e["name"] in ("outer", "inner")}
    assert set(got) == {"outer", "inner"}
    o, i = got["outer"], got["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert [r.parent for r in span_record()["inner"]] == ["outer"]


@pytest.mark.parametrize("on", [False, True])
def test_trace_turns_spans_on_and_restores(spans, tmp_path, on):
    set_spans(on)
    with trace(str(tmp_path)):
        assert profiling._SPANS.on
        with span("in_trace"):
            pass
    assert profiling._SPANS.on is on
    assert len(span_record()["in_trace"]) == 1
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
    assert any(e.get("name") == "in_trace" and e.get("cat") ==
               "user_annotation" for e in events["traceEvents"])


def _eps(x, t):
    return torch.tanh(0.7 * x + 1e-3 * t) - 0.1 * x


@pytest.mark.parametrize("name", ["ddim", "ddpm"])
def test_natural_inference_steps_and_same_output(spans, name):
    """A 10-step NI run records 10 ``ni.step`` spans and gives the same
    bits with spans off, on, and on under a CPU profile, for a
    deterministic (DDIM) and a stochastic (DDPM) matrix."""
    n = 10
    sched = NISchedule.from_matrix(registry.derive(name, n), device="cpu")
    assert sched.deterministic == (name == "ddim")
    init = torch.randn((2, 4, 4, 3), generator=torch.Generator()
                       .manual_seed(1))

    def run():
        return natural_inference(
            _eps, sched, init, prediction_type="eps",
            generator=torch.Generator().manual_seed(2))
    off = run()
    assert span_record() == {}
    set_spans(True)
    on = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = run()
    assert torch.equal(on, off) and torch.equal(profiled, off)
    steps = span_record()["ni.step"]
    assert len(steps) == 2 * n
    assert all(r.parent is None and r.host_s > 0 for r in steps)
    assert len({r.outer for r in steps}) == 2 * n


def test_sd3_pipeline_spans_and_same_images(spans, tmp_path):
    """The toy ``SD3Pipeline`` of ``test_torch_sd3.py`` from raw text:
    2 ``sd3.encode_prompt``, n ``ni.step``, n ``mmdit.forward`` (each
    inside its step) and 1 ``vae.decode`` spans, and the same images with
    spans off and on."""
    import numpy as np
    from naturaldiffusion_tpu_torch import pipeline as tpipe
    from naturaldiffusion_tpu_torch import text as ttext
    from test_text import _clip_fixture, _spm_fixture
    from test_torch_sd3 import (CG, CL, MM, T5, VA, _both, jm, jt, jv, tm,
                                tt, tv)

    ids = np.zeros((1, 12), np.int32)
    z = np.zeros((1, 8, 8, 16), np.float32)
    _, _, tmm = _both(jm.MMDiT, jm.MMDiTConfig, tm.MMDiT, tm.MMDiTConfig,
                      MM, z, np.zeros(1, np.float32),
                      np.zeros((1, 5, 96), np.float32),
                      np.zeros((1, 40), np.float32))
    tl = _both(jt.CLIPTextEncoder, jt.CLIPTextConfig, tt.CLIPTextEncoder,
               tt.CLIPTextConfig, CL, ids, seed=1)[2]
    tg = _both(jt.CLIPTextEncoder, jt.CLIPTextConfig, tt.CLIPTextEncoder,
               tt.CLIPTextConfig, CG, ids, seed=2)[2]
    t5 = _both(jt.T5Encoder, jt.T5Config, tt.T5Encoder, tt.T5Config, T5,
               ids, seed=3)[2]
    tva = _both(jv.AutoencoderKL, jv.VAEConfig, tv.AutoencoderKL,
                tv.VAEConfig, VA, np.zeros((1, 16, 16, 3), np.float32),
                seed=4)[2]
    vpath, mpath, _ = _clip_fixture(tmp_path)
    pipe = tpipe.SD3Pipeline.from_parts(
        mmdit=tmm, vae=tva, clip_l=tl, clip_g=tg, t5=t5,
        tokenizer_clip=ttext.CLIPBPETokenizer.from_files(vpath, mpath),
        tokenizer_t5=ttext.SentencePieceUnigram.from_file(
            _spm_fixture(tmp_path)))
    n = 4
    noises = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 8, 8, 16)).astype(np.float32))

    def run():
        return pipe(noises=noises, prompt=["hello low", "LOWER hello!"],
                    negative_prompt="low", num_steps=n)
    off = run()
    set_spans(True)
    on = run()
    assert off.shape == (2, 16, 16, 3) and torch.equal(on, off)
    rec = span_record()
    assert {k: len(v) for k, v in rec.items()} == {
        "sd3.encode_prompt": 2, "ni.step": n, "mmdit.forward": n,
        "vae.decode": 1}
    assert all(r.parent == "ni.step" for r in rec["mmdit.forward"])
    assert [r.outer for r in rec["mmdit.forward"]] == [
        r.outer for r in rec["ni.step"]]
    assert all(r.parent is None for k in ("sd3.encode_prompt", "ni.step",
                                          "vae.decode") for r in rec[k])


def test_graph_counters_and_spans_on_the_card(spans):
    """On a card: a span's device seconds come from its CUDA events; a
    ``GraphedNI`` replay is a ``graph.replay`` span and counts in
    ``replays``; the launch counters count the wrapper's calls, the eager
    warm-up and the capture, and no replay."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA events and graphs run on the card")
    from naturaldiffusion_tpu_torch.engine.graph import GraphedNI
    from naturaldiffusion_tpu_torch.ops.weighted_sum import fused_weighted_sum
    set_spans(True)
    x = torch.randn(2048, 2048, device="cuda")
    with span("matmul"):
        x @ x
    n, shape = 3, (2, 4, 4, 3)
    sched = NISchedule.from_matrix(registry.derive("ddpm", n), device="cuda")
    k0 = fused_weighted_sum.launches
    g = GraphedNI(_eps, sched, shape, prediction_type="eps")
    assert fused_weighted_sum.launches == k0 + n           # the warm-up
    g.capture()
    assert fused_weighted_sum.launches == k0 + 2 * n and g.replays == 0
    g.load(torch.randn(shape, device="cuda"),
           torch.Generator(device="cuda").manual_seed(0))
    g.replay()
    g.replay()
    assert fused_weighted_sum.launches == k0 + 2 * n and g.replays == 2
    rec = span_record()
    assert rec["matmul"][0].device_s > 0
    assert len(rec["graph.replay"]) == 2
    assert all(r.device_s > 0 and r.host_s > 0 for r in rec["graph.replay"])
    assert len(rec["ni.step"]) == n         # the warm-up's; a capture none
