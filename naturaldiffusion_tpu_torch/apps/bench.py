"""CIFAR-10 10-step Natural-Inference throughput on one card (port of the
repository's ``bench.py``).

The workload of ``bench.py``: the NCSN++ VP backbone
``CIFAR10_DDPMPP_CONTINUOUS`` with random bf16 weights from a seed (the
same FLOPs as ``checkpoint_8.pth``), the derived DDPM matrix
``registry.derive("ddpm", BENCH_STEPS)`` (``bench.py``'s fallback when no
learned matrix is at hand), eps prediction, f32 accumulation, and
``BENCH_TOTAL`` images a dispatch in micro-batches of ``BENCH_MICRO``
(defaults 1024, 64 and 10 steps).  A dispatch ends in one checksum that
the host reads, and a non-finite checksum raises.  The result is the
median of 5 timed dispatches after one warm dispatch.

The form is ``bench.py``'s, read from the same environment.
``BENCH_QUANT`` (``""``, ``int8``, ``int8_all``, ``int8_static``,
``int8_all_static``; default ``int8_static`` on the card, ``""`` on the
CPU, as ``bench.py:90-95``) becomes ``NATDIFF_QUANT`` around every
forward of the bench and is restored after; ``NATDIFF_PALLAS_CONV`` is
read with JAX's default ``"0"`` (the port's own default is ``"2"``), so at
its defaults the bench runs ``bench.py``'s form: every resblock unfused,
the library (cuDNN) bf16 stem and head, K6, the int8 kernel on every 3x3
conv with channel counts multiples of 128, and K1.  ``2`` runs the port's
main path, every resblock through the fused kernel K3 (``form:
"fused_bf16"`` with ``BENCH_QUANT=""``).  ``BENCH_MODS=1`` hoists the
conditioning (``models.ncsnpp.ncsnpp_schedule_biases``) once per bench,
as static inputs of the graph.  The JSON line names the form (``form``,
``conv``, ``quant``, ``mods``).

On a card each micro-batch is one replay of a CUDA graph of the whole NI
run (:class:`..engine.graph.GraphedNI`).  Before each replay the chunk's
init is copied into the graph's input and its noises are drawn from a CUDA
generator, both outside the graph.  ``BENCH_GRAPH=0`` runs the same loop
eagerly, as the control.  A capture that fails raises.

    python -m naturaldiffusion_tpu_torch.apps.bench [--trace DIR]
    BENCH_GRAPH=0 python -m naturaldiffusion_tpu_torch.apps.bench
    BENCH_TOTAL=4 BENCH_MICRO=2 BENCH_STEPS=2 \\
        python -m naturaldiffusion_tpu_torch.apps.bench --device cpu

Prints one JSON line with ``bench.py``'s fields, less ``vs_baseline``
(its 1000 img/s target is a TPU's); :func:`measure` returns that record
for a :class:`Bench` built and warmed by the caller.  ``flops_per_img_step`` is counted by
PyTorch's FLOP counter over one image's forward on the CPU, in a
subprocess that runs while the bench builds and warms up (``--flops-only``
prints it and exits).  ``mfu`` divides by the
H100's dense bf16 peak, ``mfu_vs_int8_peak`` (with a quant mode) by its
dense int8 peak.  ``--trace DIR`` profiles one more dispatch with
``torch.profiler``, prints ``utils.trace_summary``'s table and reports the
card's busy share of that dispatch (``busy``).  ``--device cpu`` (or
``BENCH_DEVICE=cpu``) runs the plain versions on the CPU; without a card
and without it, the bench raises.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from ..coeffs import registry
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..engine.graph import GraphedNI
from ..models.ncsnpp import (CIFAR10_DDPMPP_CONTINUOUS, NCSNpp,
                             ncsnpp_schedule_biases)
from ..ops.quant import MODES as QUANT_MODES
from ..utils.flops import (H100_BF16_PEAK, H100_INT8_PEAK, flops_counted,
                           flops_via_cpu_subprocess)
from ..utils import trace_summary
from ..utils.profiling import trace

METRIC = "cifar10_ni10_img_per_sec_per_chip"
SEED = 0
IMAGE = (32, 32, 3)
CONV_FLAGS = ("0", "1", "2")


def form_name(conv: str, quant: str) -> str:
    """``fused_<quant>`` under ``NATDIFF_PALLAS_CONV=2``, else
    ``unfused_<quant>``; ``<quant>`` is the mode or ``bf16``."""
    return f"{'fused' if conv == '2' else 'unfused'}_{quant or 'bf16'}"


def settings() -> dict:
    """The env overrides, read at call time (tests set them per case).
    ``quant`` is None when ``BENCH_QUANT`` is unset: :func:`main` then takes
    ``int8_static`` on a card and ``""`` on the CPU."""
    micro = int(os.environ.get("BENCH_MICRO", "64"))
    total = int(os.environ.get("BENCH_TOTAL", "1024"))
    if micro <= 0 or total % micro:
        raise ValueError(f"BENCH_MICRO={micro} must divide "
                         f"BENCH_TOTAL={total}")
    quant = os.environ.get("BENCH_QUANT")
    if quant not in (None, "") + QUANT_MODES:
        raise ValueError(f"unknown BENCH_QUANT {quant!r}: one of "
                         f"{('',) + QUANT_MODES}")
    conv = os.environ.get("NATDIFF_PALLAS_CONV", "0")
    if conv not in CONV_FLAGS:
        raise ValueError(f"unknown NATDIFF_PALLAS_CONV {conv!r}: one of "
                         f"{CONV_FLAGS}")
    return dict(micro=micro, total=total,
                steps=int(os.environ.get("BENCH_STEPS", "10")),
                graph=os.environ.get("BENCH_GRAPH"), quant=quant, conv=conv,
                mods=os.environ.get("BENCH_MODS", "0") != "0")


@contextlib.contextmanager
def form_env(conv: str, quant: str):
    """``NATDIFF_PALLAS_CONV`` and ``NATDIFF_QUANT`` set to a bench form
    within the block and restored after (the layers read them per call)."""
    saved = {k: os.environ.get(k) for k in ("NATDIFF_PALLAS_CONV",
                                            "NATDIFF_QUANT")}
    os.environ["NATDIFF_PALLAS_CONV"] = conv
    if quant:
        os.environ["NATDIFF_QUANT"] = quant
    else:
        os.environ.pop("NATDIFF_QUANT", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Bench:
    """The model, the schedule and the dispatch's inputs on one device, in
    one form: ``conv`` (``NATDIFF_PALLAS_CONV``), ``quant``
    (``NATDIFF_QUANT``, ``""`` for none), ``mods`` (the conditioning
    hoisted once, ``ncsnpp_schedule_biases``).  ``net``: a bf16 NCSN++ of
    the bench's config on the device to run instead of building one from
    the seed (a caller that benches several forms on one set of weights).

    ``zs`` ``[TOTAL / MICRO, MICRO, 32, 32, 3]`` float32 is the same in
    every dispatch; each dispatch draws its noises from a generator seeded
    anew.  With ``graph`` the micro-batch's NI run is captured once, after
    an eager warm-up that builds the int8 weights (and runs the dynamic
    scales' reductions once) outside the capture."""

    def __init__(self, *, micro: int, total: int, steps: int, device,
                 graph: bool, conv: str = "2", quant: str = "",
                 mods: bool = False, net=None):
        self.dev = resolve_device(device)
        if graph and self.dev.type != "cuda":
            raise ValueError("BENCH_GRAPH=1 needs a CUDA device: a CUDA "
                             "graph has no CPU form")
        if conv not in CONV_FLAGS or quant not in ("",) + QUANT_MODES:
            raise ValueError(f"unknown bench form conv={conv!r}, "
                             f"quant={quant!r}")
        self.micro, self.total, self.steps = micro, total, steps
        self.conv, self.quant = conv, quant
        self.form = form_name(conv, quant)
        self.nchunk = total // micro
        self.net = net if net is not None else NCSNpp(
            CIFAR10_DDPMPP_CONTINUOUS, device=self.dev,
            seed=SEED).to(torch.bfloat16).eval()
        self.sched = NISchedule.from_matrix(registry.derive("ddpm", steps),
                                            device=self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 1)
        self.zs = torch.randn((self.nchunk, micro) + IMAGE, generator=gen,
                              device=self.dev)
        self.kwargs = dict(prediction_type="eps", model_dtype=torch.bfloat16)
        self.mods = None
        if mods:
            self.mods = ncsnpp_schedule_biases(
                self.net, self.sched.node[:steps, 0], dtype=torch.bfloat16)
            self.kwargs["step_inputs"] = self.mods
        self.graphed = None
        if graph:
            self.graphed = GraphedNI(self.eps_fn, self.sched,
                                     (micro,) + IMAGE, **self.kwargs)
            self.graphed.capture()

    def eps_fn(self, z, t, mods=None):
        with form_env(self.conv, self.quant):
            return self.net(z, t.reshape(1).expand(z.shape[0]), mods=mods)

    @torch.no_grad()
    def chunk(self, c: int, generator: torch.Generator) -> torch.Tensor:
        """Samples of micro-batch ``c``, its noises drawn from
        ``generator``: a replay of the graph (valid until the next replay)
        when the bench has one, else :meth:`eager_chunk`."""
        if self.graphed is None:
            return self.eager_chunk(c, generator)
        self.graphed.load(self.zs[c], generator)
        return self.graphed.replay()

    @torch.no_grad()
    def eager_chunk(self, c: int, generator: torch.Generator) -> torch.Tensor:
        """The same samples by the eager loop, the graph's control."""
        noises = None
        if not self.sched.deterministic:
            noises = torch.randn((self.steps, self.micro) + IMAGE,
                                 generator=generator, device=self.dev)
        return natural_inference(self.eps_fn, self.sched, self.zs[c],
                                 noises=noises, **self.kwargs)

    def dispatch(self, seed: int, chunks: int | None = None) -> float:
        """All TOTAL images (the first ``chunks`` micro-batches if given);
        the sum of every sample, read by the host.  Raises on a non-finite
        sum (NaN or Inf anywhere makes it so)."""
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        total = torch.zeros((), dtype=torch.float32, device=self.dev)
        for c in range(self.nchunk if chunks is None else chunks):
            total += self.chunk(c, gen).sum()
        s = float(total)
        if not math.isfinite(s):
            raise FloatingPointError(f"non-finite checksum {s}")
        return s


def count_flops_per_image() -> int:
    """FLOPs of one forward at one image, float32 on the CPU (the same
    products as bf16), as PyTorch's counter sees them."""
    net = NCSNpp(CIFAR10_DDPMPP_CONTINUOUS, device="cpu", seed=SEED).eval()
    return flops_counted(lambda z: net(z, torch.full((1,), 500.0)),
                         torch.zeros((1,) + IMAGE))


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"{torch.cuda.get_device_name(0)} (nvidia-smi failed)")


def profile_dispatch(bench: Bench, logdir: str, seed: int,
                     chunks: int | None = None) -> dict:
    """One dispatch (of ``chunks`` micro-batches if given) under
    ``torch.profiler``: its wall time, the card's time from the trace and
    their ratio (the busy share); prints the trace summary's table.
    ``trace_s`` is the whole profiled block's wall time, the profiler's
    processing and the trace's export included."""
    t_trace = time.perf_counter()
    with trace(logdir):
        t0 = time.perf_counter()
        bench.dispatch(seed, chunks)
        wall = time.perf_counter() - t0
    trace_s = time.perf_counter() - t_trace
    device_us, fam = trace_summary.summarize(logdir)
    trace_summary.print_table(device_us, fam, top=8)
    return dict(wall_s=wall, device_s=device_us / 1e6,
                busy=device_us / 1e6 / wall, trace_s=trace_s,
                chunks=bench.nchunk if chunks is None else chunks)


def measure(bench: Bench, flops: int, trace_dir: str | None = None,
            trace_chunks: int | None = None, dispatches: int = 5) -> dict:
    """The bench's JSON record: ``dispatches`` (5) timed dispatches of a
    warmed ``bench`` (their median sets ``value``), then with ``trace_dir``
    one more dispatch (of ``trace_chunks`` micro-batches if given) profiled
    into it.  ``flops`` is one image's forward, as
    :func:`count_flops_per_image` counts it."""
    def timed(seed):
        t0 = time.perf_counter()
        bench.dispatch(seed)
        return time.perf_counter() - t0

    times = [timed(3 + i) for i in range(dispatches)]
    img_per_sec = bench.total / statistics.median(times)
    prof = None
    if trace_dir:
        prof = profile_dispatch(bench, trace_dir, 99, trace_chunks)
    on_card = bench.dev.type == "cuda"
    out = {
        "metric": METRIC,
        "value": round(img_per_sec, 2),
        "unit": "img/s",
        "flops_per_img_step": flops,
        "flops_source": "counted: torch FLOP counter, one image, CPU",
        "mfu": (round(img_per_sec * bench.steps * flops / H100_BF16_PEAK, 4)
                if on_card else None),
        "micro_batch": bench.micro,
        "total_batch": bench.total,
        "steps": bench.steps,
        "form": bench.form,
        "conv": bench.conv,
        "quant": bench.quant,
        "mods": bench.mods is not None,
        "mfu_vs_int8_peak": (
            round(img_per_sec * bench.steps * flops / H100_INT8_PEAK, 4)
            if on_card and bench.quant else None),
        "graph": bench.graphed is not None,
        "card": card_name() if on_card else "cpu",
        "busy": None if prof is None else round(prof["busy"], 4),
        "dispatch_s": times,
    }
    if bench.graphed is not None:
        out["capture_s"] = bench.graphed.capture_s
        out["graph_pool_bytes"] = bench.graphed.pool_bytes
    if prof is not None:
        out["traced_dispatch"] = prof
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile one more dispatch into DIR and report the "
                        "card's busy share")
    p.add_argument("--flops-only", action="store_true",
                   help="print the FLOPs of one image's forward, counted on "
                        "the CPU, and exit")
    p.add_argument("--device", default=os.environ.get("BENCH_DEVICE",
                                                      "cuda"))
    args = p.parse_args(argv)
    if args.flops_only:
        print(count_flops_per_image(), flush=True)
        return 0
    cfg = settings()
    dev = resolve_device(args.device)
    graph = (dev.type == "cuda" if cfg["graph"] is None
             else cfg["graph"] != "0")
    quant = cfg["quant"]
    if quant is None:          # bench.py:90-95: int8 on the accelerator only
        quant = "int8_static" if dev.type == "cuda" else ""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        counting = pool.submit(flops_via_cpu_subprocess,
                               "naturaldiffusion_tpu_torch.apps.bench", [])
        bench = Bench(micro=cfg["micro"], total=cfg["total"],
                      steps=cfg["steps"], device=dev, graph=graph,
                      conv=cfg["conv"], quant=quant, mods=cfg["mods"])
        bench.dispatch(2)                     # warm dispatch
        flops = int(counting.result())        # done before the timed ones
    print(json.dumps(measure(bench, flops, trace_dir=args.trace)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
