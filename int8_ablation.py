"""Ablations of the int8 conv kernel (Q1, ``csrc/conv3x3_int8.cu``) on one card.

Builds copies of the kernel's source with parts taken out (the weight or
halo copies after the first, the quantize, the products, the epilogue, the
split-K sum over distributed shared memory) or
changed (the tap loop not unrolled), and times each beside it at
batch-64 CIFAR shapes in two ways: ``chip_smoke.Timer`` (L2 flushed before
every launch, as ``chip_smoke.py`` times Q1) and warm (10 launches captured
in one CUDA graph, replayed, as the port bench runs them).  A variant whose
output must equal the kernel's is checked bit for bit.  Where a variant
makes the time fall, what it took out bounds the kernel; where none does,
what all of them keep does.

    python3 int8_ablation.py [--out chiprun_out/int8_ablation.json]

Needs a card and ``nvcc``; run it from the repository's root.  Each copy
builds in a few seconds, all at once.  A patch whose text the source no
longer holds fails the run: update ``PATCHES`` with the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import chip_smoke as CS

# the text each patch replaces, and what replaces it
_WEIGHTS = ("""              mbar_expect_tx(bar(s), WSTAGE);
              tma_load_5d(ring_s + s * WSTAGE, &wmap, c * BK, 0, 0, 0,
                          tap * (Cout / BN) + n0 / BN, bar(s));""",
            """              if (it < STAGES) {
                mbar_expect_tx(bar(s), WSTAGE);
                tma_load_5d(ring_s + s * WSTAGE, &wmap, c * BK, 0, 0, 0,
                            tap * (Cout / BN) + n0 / BN, bar(s));
              } else {
                mbar_arrive(bar(s));
              }""")
_HALO = ("    if (qt == 0) {\n          if (c + 1 < c0 + kcs)\n            issue_x(u, c + 1);\n          else if (u + ustep < pl.units)\n            issue_x(u + ustep, c0);\n        }",
         "    if (qt == 0 && (c + 1 < c0 + kcs || u + ustep < pl.units))\n          mbar_arrive(bar(SFULL));")
_QUANT = ("for (int v = qt; v < rows * 16; v += QUANT)",
          "for (int v = qt; v < 0; v += QUANT)")
_PRODUCTS = ("for (int ks = 0; ks < 4; ++ks) "
             "wgmma_m64n128k32_s8_rs(acc, af[ks], desc[ks]);", "")
_EPILOGUE = ("if (!(b < B && oh < H && ow < W)) continue;",
             "if (B > 0) continue;")
_UNROLL = ("#pragma unroll\n      for (int tap = 1; tap < 9; tap += 2)",
           "#pragma unroll 1\n      for (int tap = 1; tap < 9; tap += 2)")
_REDUCE = ("    if (S > 1) {\n      // split-K:",
           "    if (S > 1 && rank != 0) return;\n    if (false) {\n      // split-K:")
# variant: (patches, output equal to the kernel's)
PATCHES = {
    "no_weight_copies": ((_WEIGHTS,), False),
    "no_halo_copies": ((_HALO,), False),
    "no_quantize": ((_QUANT,), False),
    "no_products": ((_PRODUCTS,), False),
    "no_epilogue": ((_EPILOGUE,), False),
    "products_only": ((_WEIGHTS, _HALO, _QUANT, _EPILOGUE), False),
    "loop_only": ((_WEIGHTS, _HALO, _QUANT, _PRODUCTS, _EPILOGUE), False),
    "taps_not_unrolled": ((_UNROLL,), True),
    "loop_only_not_unrolled": ((_UNROLL, _WEIGHTS, _HALO, _QUANT, _PRODUCTS,
                                _EPILOGUE), False),
    "no_split_k_sum": ((_REDUCE,), False),
}
SHAPES = (((64, 32, 32, 128), 128), ((64, 32, 32, 256), 256),
          ((64, 16, 16, 256), 256), ((64, 16, 16, 512), 256),
          ((64, 8, 8, 256), 256), ((64, 4, 4, 256), 256))


def build(out: Path) -> dict:
    """Every patched copy compiled at once into ``out``: {name: library}."""
    from naturaldiffusion_tpu_torch.ops import _cuda
    src = (_cuda.CSRC / "conv3x3_int8.cu").read_text()
    procs = {}
    for name, (patches, _) in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise AssertionError(f"{name}: the kernel no longer holds "
                                     f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        with open(out / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                 "-o", str(out / f"lib{name}.so"), str(cu)],
                stdout=log, stderr=subprocess.STDOUT)
    _cuda.build(["conv3x3_int8"])
    libs = {"kernel": _cuda.library_path("conv3x3_int8")}
    for name, proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}: "
                               f"{(out / f'{name}.log').read_text()}")
        libs[name] = out / f"lib{name}.so"
        for fn, regs, spill in CS.kernel_ptxas(out / f"{name}.log"):
            print(f"  ptxas {name} {fn}: {regs} registers, {spill} bytes "
                  f"spilled", flush=True)
    return libs


def warm_ms(torch, launch) -> float:
    """Milliseconds a launch: 10 launches captured in one CUDA graph after
    an eager one on a side stream, the graph replayed 5 times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("int8_ablation: no CUDA device", file=sys.stderr)
        return 2
    from naturaldiffusion_tpu_torch.ops import _cuda
    from naturaldiffusion_tpu_torch.ops import quant as Q
    smi = CS.phase_env()
    out = Path("chiprun_out") / "int8_ablation"
    out.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, path in build(out).items():
        fn = ctypes.CDLL(str(path)).natdiff_conv3x3_int8
        fn.argtypes, fn.restype = Q._ARGTYPES, ctypes.c_int
        fns[name] = fn
    timer = CS.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(CS.SEED + 40)
    s_static, q_mul = Q.static_scales(Q.static_amax())
    rows = []
    for xs, cout in SHAPES:
        x = (2 * torch.randn(xs, device="cuda", generator=gen)).bfloat16()
        _, s_w, wk = Q.quantize_conv_weight(
            (torch.randn(3, 3, xs[3], cout, device="cuda", generator=gen)
             / math.sqrt(9 * xs[3])).bfloat16())
        sx = Q.dynamic_scales(x)
        ys = {}
        row = dict(shape=[list(xs), cout], plan=Q._int8_plan(*xs, cout),
                   gop=2.0 * math.prod(xs) * 9 * cout / 1e9)
        for name, fn in fns.items():
            y = torch.empty(xs[:3] + (cout,), dtype=torch.bfloat16,
                            device="cuda")
            for dyn in (0, 1):
                def launch(fn=fn, y=y, dyn=dyn):
                    err = fn(dyn, x.data_ptr(), wk.data_ptr(), s_w.data_ptr(),
                             None, sx.data_ptr() if dyn else None, q_mul,
                             s_static, y.data_ptr(), *xs, cout,
                             *Q._plan_ints(*xs, cout),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                mode = "dynamic" if dyn else "static"
                launch()
                ys[(name, dyn)] = y.clone()
                row[f"{name}_{mode}_ms"] = timer(launch)
                if not dyn:
                    row[f"{name}_warm_ms"] = warm_ms(torch, launch)
            if name != "kernel" and PATCHES[name][1]:
                for dyn in (0, 1):
                    if not torch.equal(ys[(name, dyn)].view(torch.int16),
                                       ys[("kernel", dyn)].view(torch.int16)):
                        raise AssertionError(f"{name} {xs}: output differs "
                                             f"from the kernel's")
        rows.append(row)
        print(f"{xs} -> {cout} ({row['gop']:.1f} GOP): " + "; ".join(
            f"{n} {row[f'{n}_static_ms'] * 1e3:.1f}/"
            f"{row[f'{n}_warm_ms'] * 1e3:.1f}/"
            f"{row[f'{n}_dynamic_ms'] * 1e3:.1f}" for n in fns) +
            "  (µs: flushed static / warm static / flushed dynamic)",
            flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=smi, rows=rows), fh, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
