"""Ablations of the attention backward's wgmma pass (K9ᵇ/K10ᵇ,
``csrc/attention_bwd.cu``, bf16 at head dims 64 and 72) on one card.

Builds copies of the kernel's source with one thing changed and times each
beside the kernel with ``chip_smoke.Timer`` (L2 flushed before every call,
as ``chip_smoke.py`` times the backward) at the backward's timed shapes
(``chip_smoke.BWD_TIMED``):

* ``stamps``: ``clock64()`` at eight points of each consumer warpgroup's
  loop in block (1, 7), printed as the mean clocks a query tile spends in
  each phase (ring wait, S^T/dP^T, exp2 and packing, dV/dK issue with the
  dS^T store, their wait, dQ, the staging of its f32 part) and the
  warpgroups' offset;
* ``scheduled``: FA3's warp-scheduler barriers put in (the warpgroups
  take turns to issue their products; without them each issues whenever
  it is ready);
* ``no_dq_reduce``: the writer warps' bulk reductions taken out;
* ``no_exp``: exp2 replaced by its argument (the MUFU's share).

Before the variants, ``torch.profiler`` reads the device time of each of
the kernel's three launches (pre-pass, wgmma pass, dq post-pass) over
five calls, the L2 flushed before each.

A variant whose output must equal the kernel's is checked: dk and dv bit
for bit, dq within twice the kernel's own run-to-run difference (its key
blocks add in no fixed order).

    python3 attention_bwd_ablation.py [--out FILE.json]

Needs a card and ``nvcc``; run it from the repository's root.  A patch
whose text the source no longer holds fails the run: update ``PATCHES``
with the kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import chip_smoke as CS

STAMP_BLOCK = (1, 7)     # the block whose warpgroups record clocks
PHASES = ("ring wait", "S^T, dP^T", "exp2 and packing",
          "dV, dK issue + dS^T store", "dV, dK wait", "dQ", "dQ staging")


def _stamp(k: int) -> str:
    return (f"    if ((tid & 127) == 0 && blockIdx.x == {STAMP_BLOCK[0]} && "
            f"blockIdx.y == {STAMP_BLOCK[1]} && i < 64)\n"
            f"      g_stamps[(wg * 64 + i) * 8 + {k}] = clock64();\n")


def _after(anchor: str, k: int):
    return anchor, anchor + _stamp(k)


def _before(anchor: str, k: int):
    return anchor, _stamp(k) + anchor


_STAMPS = (
    ('#include "mma_sm90.cuh"\n',
     '#include "mma_sm90.cuh"\n__device__ long long g_stamps[1024];\n'),
    ('extern "C" {\n',
     'extern "C" {\nint natdiff_ablation_stamps(long long* out) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n'
     '}\n'),
    _before("    mbar_wait(full + 8 * s, (i / STAGES) & 1);\n", 0),
    _after("    mbar_wait(full + 8 * s, (i / STAGES) & 1);\n", 1),
    _after("      keep(sa[e]);\n      keep(pa[e]);\n    }\n", 2),
    _before("    wgmma_fence();\n#pragma unroll\n    for (int k4", 3),
    _after("    named_barrier(BAR_WG + wg, 128);\n", 4),
    _after("    if (lane == 0) mbar_arrive(empty + 8 * s);\n", 5),
    _after("    for (int e = 0; e < L::NA; ++e) keep(qa[e]);\n", 6),
    _after("    named_barrier_arrive(BAR_DQ_FULL + wg, 160);\n", 7),
)
# FA3's warp-scheduler barriers: the warpgroups take turns to issue their
# products (S^T and dP^T, dV and dK, dQ; warpgroup 0 first), named barriers
# 7 + w, so that one's exp2 and packing might run under the other's products
_SCHEDULED = (
    ("  mbar_wait(kvbar, 0);\n",
     "  mbar_wait(kvbar, 0);\n  if (wg == 1) named_barrier_arrive(7, 256);\n"),
    ("    float sa[32], pa[32];\n    wgmma_fence();\n",
     "    float sa[32], pa[32];\n    named_barrier(7 + wg, 256);\n"
     "    wgmma_fence();\n"),
    ("    wgmma_commit();\n\n    // P^T = exp2",
     "    wgmma_commit();\n    named_barrier_arrive(8 - wg, 256);\n\n"
     "    // P^T = exp2"),
    ("      }\n    wgmma_fence();\n#pragma unroll\n    for (int k4",
     "      }\n    named_barrier(7 + wg, 256);\n    wgmma_fence();\n"
     "#pragma unroll\n    for (int k4"),
    ("mma_rs_t<D>(dk, df[k4], qmn + k4 * 128);\n    wgmma_commit();\n",
     "mma_rs_t<D>(dk, df[k4], qmn + k4 * 128);\n    wgmma_commit();\n"
     "    named_barrier_arrive(8 - wg, 256);\n"),
    ("    float qa[L::NA];\n    wgmma_fence();\n",
     "    float qa[L::NA];\n    named_barrier(7 + wg, 256);\n"
     "    wgmma_fence();\n"),
    ("kmn + kk * 128);\n    wgmma_commit();\n",
     "kmn + kk * 128);\n    wgmma_commit();\n"
     "    if (wg == 0 || i + 1 < nq) named_barrier_arrive(8 - wg, 256);\n"),
)
_NO_REDUCE = (("          bulk_reduce_add_f32(accg + (long long)i * BQ * D, "
               "stage, L::DQ);\n", ""),)
_NO_EXP = (("ex2(sa[e] * a.scale_log2 - l.x)", "(sa[e] * a.scale_log2 - l.x)"),
           ("ex2(sa[e + 1] * a.scale_log2 - l.y)",
            "(sa[e + 1] * a.scale_log2 - l.y)"))
# variant: (patches, output equal to the kernel's); a patch replaces every
# occurrence of its text
PATCHES = {
    "stamps": (_STAMPS, True),
    "scheduled": (_SCHEDULED, True),
    "no_dq_reduce": (_NO_REDUCE, False),
    "no_exp": (_NO_EXP, False),
}


def patched(src: str, name: str) -> str:
    for old, new in PATCHES[name][0]:
        if old not in src:
            raise AssertionError(f"{name}: the kernel no longer holds "
                                 f"{old!r}")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict:
    """Every patched copy compiled at once into ``out``: {name: library}."""
    from naturaldiffusion_tpu_torch.ops import _cuda
    src = (_cuda.CSRC / "attention_bwd.cu").read_text()
    procs = {}
    for name in PATCHES:
        cu = out / f"{name}.cu"
        cu.write_text(patched(src, name))
        with open(out / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(out / f"lib{name}.so"), str(cu)],
                stdout=log, stderr=subprocess.STDOUT)
    _cuda.build(["attention", "attention_bwd"])
    libs = {"kernel": _cuda.library_path("attention_bwd")}
    for name, proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}: "
                               f"{(out / f'{name}.log').read_text()}")
        libs[name] = out / f"lib{name}.so"
        for fn, regs, spill in CS.kernel_ptxas(out / f"{name}.log"):
            if "wgmma" in fn:
                print(f"  ptxas {name} {fn}: {regs} registers, {spill} "
                      f"bytes spilled", flush=True)
    return libs


@contextlib.contextmanager
def entry(A, lib):
    """The backward's C entry taken from ``lib`` for the duration."""
    from naturaldiffusion_tpu_torch.ops import _cuda
    key = ("attention_bwd", "natdiff_attention_bwd")
    fn = ctypes.CDLL(str(lib)).natdiff_attention_bwd
    fn.argtypes, fn.restype = A._BWD_ARGTYPES, ctypes.c_int
    saved = _cuda.entry(*key, A._BWD_ARGTYPES)
    _cuda._bound[key] = fn
    try:
        yield
    finally:
        _cuda._bound[key] = saved


def phases(lib, nq: int) -> dict:
    """Mean clocks a query tile spends in each phase, per warpgroup, over
    the block's tiles after its first (at most 63), and warpgroup 1's
    start offset from warpgroup 0's."""
    buf = (ctypes.c_longlong * 1024)()
    ctypes.CDLL(str(lib)).natdiff_ablation_stamps(buf)
    st = [[buf[(wg * 64 + i) * 8:(wg * 64 + i) * 8 + 8]
           for i in range(min(nq, 64))] for wg in range(2)]
    out = {}
    for wg in range(2):
        its = st[wg][1:]
        out[f"wg{wg}"] = dict(
            tile_clocks=sum(its[i + 1][0] - its[i][0]
                            for i in range(len(its) - 1)) / (len(its) - 1),
            **{p: sum(t[k + 1] - t[k] for t in its) / len(its)
               for k, p in enumerate(PHASES)})
    out["wg1_minus_wg0_start"] = sum(
        st[1][i][0] - st[0][i][0] for i in range(1, len(st[0]))) / (
        len(st[0]) - 1)
    return out


def launch_ms(torch, bwd, flush) -> dict:
    """Device milliseconds a call of each of the backward's launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            bwd()
        torch.cuda.synchronize()
    return {ev.key.split("::")[-1].split("<")[0]: ev.device_time_total / 5e3
            for ev in prof.key_averages()
            if ev.device_time_total > 0 and "hop::" in ev.key}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    from naturaldiffusion_tpu_torch.ops import attention as A
    smi = CS.phase_env()
    from naturaldiffusion_tpu_torch.ops import _cuda
    out = _cuda.BUILD_ROOT / "bwd_ablation"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(out)
    timer = CS.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(CS.SEED + 90)
    rows = []
    for shape in CS.BWD_TIMED:
        q, k, v, do = CS.bwd_inputs(torch, shape, torch.bfloat16, gen)
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = A._launch(q, k, v, scale, True, "flash_attention")
        bwd = lambda: A.flash_attention_backward(q, k, v, o, do, lse, scale)  # noqa: E731
        row = dict(shape=list(shape),
                   launch_ms=launch_ms(torch, bwd, timer.flush))
        print(f"{shape}: device ms a launch {row['launch_ms']}", flush=True)
        want = None
        for name, lib in libs.items():
            with entry(A, lib):
                got = [x.clone() for x in bwd()]
                if name == "kernel":
                    want = got
                    again = bwd()
                    r2r = float((again[0].float() - got[0].float()).abs().max())
                    row["kernel_run_to_run_dq"] = r2r
                elif PATCHES[name][1]:
                    dq_diff = float((got[0].float() - want[0].float()).abs().max())
                    if not (torch.equal(got[1], want[1])
                            and torch.equal(got[2], want[2])
                            and dq_diff <= 2 * max(r2r, 2.0 ** -10)):
                        raise AssertionError(f"{name} {shape}: output differs "
                                             f"from the kernel's (dq by "
                                             f"{dq_diff})")
                row[f"{name}_ms"] = timer(bwd)
                if name == "stamps":
                    bwd()
                    torch.cuda.synchronize()
                    row["phases"] = phases(lib, -(-shape[2] // A._BWD_BQ))
        rows.append(row)
        print(f"{shape}: " + "; ".join(f"{n} {row[f'{n}_ms']:.4f}"
                                       for n in libs) + " ms", flush=True)
        if "phases" in row:
            print(f"  clocks a query tile in block {STAMP_BLOCK}: "
                  f"{json.dumps(row['phases'])}", flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, rows=rows), fh, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
