"""Summarize a ``torch.profiler`` Chrome trace into a table of kernel
families (port of ``naturaldiffusion_tpu/utils/trace_summary.py``, which
reads xprof traces).

:func:`.profiling.trace` (or ``prof.export_chrome_trace``) writes a JSON
trace; the card's work is in its ``"ph": "X"`` events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``, with durations in
microseconds.  Kernel names are folded into families by stripping template
arguments, parameter lists and ``.N`` suffixes, so
``void (anonymous namespace)::flash_kernel<__nv_bfloat16, 64, false>(...)``
becomes ``flash_kernel``; each family's share of the device time follows.

With ``--bytes N`` (bytes moved by ONE instance of ``--family``) the table
also prints the achieved GB/s, to read against the card's memory rate:
3350 GB/s for an NVIDIA H100 SXM (HBM3, NVIDIA's data sheet).

Usage::

    python -m naturaldiffusion_tpu_torch.utils.trace_summary /tmp/prof
    python -m naturaldiffusion_tpu_torch.utils.trace_summary /tmp/prof \
        --family gn_apply_kernel --bytes 67108864 --count 57
"""

from __future__ import annotations

import argparse
import collections
import functools
import glob
import gzip
import json
import os
import re

H100_HBM_GBPS = 3350.0      # NVIDIA H100 SXM, HBM3, data sheet
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _find_trace(logdir: str) -> str:
    found = [p for pat in ("*.pt.trace.json", "*.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pat),
                                recursive=True)]
    if not found:
        raise FileNotFoundError(f"no *.pt.trace.json or *.json.gz under "
                                f"{logdir}")
    return max(found, key=os.path.getmtime)


def _strip_brackets(name: str, open_c: str, close_c: str) -> str:
    """``name`` without any ``open_c ... close_c`` group, nesting included."""
    out, depth = [], 0
    for ch in name:
        if ch == open_c:
            depth += 1
        elif ch == close_c and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _family(name: str) -> str:
    # parsed once per name: a trace repeats a few hundred names over its
    # events.  void (anonymous namespace)::flash_kernel<bf16, 64>(...) ->
    # flash_kernel; at::native::vectorized_elementwise_kernel<4, ...>(...) ->
    # vectorized_elementwise_kernel; Memcpy HtoD (Pageable -> Device) ->
    # Memcpy HtoD; ampere_bf16_s16816gemm.2 -> ampere_bf16_s16816gemm
    name = name.replace("(anonymous namespace)::", "")
    name = _strip_brackets(_strip_brackets(name, "<", ">"), "(", ")")
    name = name.strip()
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.split("::")[-1].strip()
    return re.sub(r"\.\d+", "", name)


def load_events(logdir: str) -> list[dict]:
    """The device events (``"ph": "X"``, category kernel / memcpy / memset)
    of the newest trace under ``logdir``."""
    path = _find_trace(logdir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and "dur" in e]


def summarize(logdir: str):
    """-> (total_device_us, {family: us}) over the device events of the
    newest trace under ``logdir``."""
    fam = collections.Counter()
    for e in load_events(logdir):
        fam[_family(e.get("name", ""))] += float(e["dur"])
    return sum(fam.values()), dict(fam)


def print_table(total: float, fam: dict, top: int = 15) -> None:
    """The device total and the ``top`` families by time, with shares."""
    print(f"device total: {total / 1e3:.3f} ms")
    for name, us in sorted(fam.items(), key=lambda kv: -kv[1])[:top]:
        share = us / total * 100 if total else 0.0
        print(f"{us / 1e3:10.3f} ms  {share:5.1f}%  {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--family", help="print achieved GB/s for this family")
    ap.add_argument("--bytes", type=float, default=0.0,
                    help="bytes moved per instance of --family")
    ap.add_argument("--count", type=int, default=1,
                    help="number of --family instances in the trace window")
    args = ap.parse_args(argv)

    total, fam = summarize(args.logdir)
    print_table(total, fam, args.top)
    if args.family:
        us = fam.get(args.family, 0)
        if us and args.bytes:
            gbps = args.bytes * args.count / (us * 1e-6) / 1e9
            print(f"\n{args.family}: {us / 1e3:.3f} ms for {args.count} x "
                  f"{args.bytes / 1e6:.2f} MB -> {gbps:.0f} GB/s achieved "
                  f"({gbps / H100_HBM_GBPS * 100:.1f}% of the NVIDIA H100 "
                  f"SXM's {H100_HBM_GBPS:.0f} GB/s)")
        else:
            print(f"\n{args.family}: {us / 1e3:.3f} ms in trace")
    return 0


if __name__ == "__main__":
    main()
