"""A profiled stretch of a run, reduced to what the per-layer metrics read.

``torch.profiler`` with CPU and CUDA activity records the block; its Chrome
trace is written to one fixed file inside the checkout, read and deleted.
From it come:

* the device intervals (events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``), each with its kernel family: the name folded as the
  port's ``utils/trace_summary.py`` folds it (template arguments,
  parameter lists, namespaces and ``.N`` suffixes stripped), so
  ``void tc::conv3x3_tc_kernel<...>(...)`` is ``conv3x3_tc_kernel``;
* the benchmark's own spans (``record_function`` in the harness and the
  configurations, category ``user_annotation``) and the host's operators
  (``cpu_op``), on the same clock as the device's.

The window is the span of the profiled requests.  ``busy_s`` is the length
of the union of the device intervals inside it, so overlapping kernels
count once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST_SPAN = "request"


def _strip(name: str, open_c: str, close_c: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == open_c:
            depth += 1
        elif ch == close_c and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def family(name: str) -> str:
    """The kernel family of a device event's name."""
    name = name.replace("(anonymous namespace)::", "")
    name = _strip(_strip(name, "<", ">"), "(", ")").strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return re.sub(r"\.\d+", "", name.split("::")[-1].strip())


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclass
class Profile:
    """The reduced trace.  Times in microseconds on the trace's clock."""

    t0: float
    t1: float
    device: list = field(default_factory=list)    # (family, start, dur)
    spans: list = field(default_factory=list)     # (name, start, dur)
    host_ops: list = field(default_factory=list)  # (name, start, dur)
    requests: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self):
        for fam, s, d in self.device:
            a, b = max(s, self.t0), min(s + d, self.t1)
            if b > a:
                yield fam, a, b

    @property
    def busy_s(self) -> float:
        return union_us((a, b) for _, a, b in self._clipped()) / 1e6

    def family_s(self, families) -> float:
        """Device seconds of the given kernel families in the window."""
        fams = set(families)
        return sum(b - a for f, a, b in self._clipped() if f in fams) / 1e6

    def count(self, families) -> int:
        fams = set(families)
        return sum(1 for f, _, _ in self._clipped() if f in fams)

    def top_device_ops(self, n=10):
        acc = collections.Counter()
        for f, a, b in self._clipped():
            acc[f] += (b - a) / 1e6
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n=10):
        """Idle device time in the window, summed by what the host was in:
        the innermost benchmark span and the outermost host operator at
        the gap's end (the call that launched the work that ended it)."""
        merged = []
        for _, a, b in sorted(self._clipped(), key=lambda x: x[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [self.t0] + [x for m in merged for x in m] + [self.t1]
        top = []                       # outermost host operators, in order
        for name, s, d in sorted(self.host_ops, key=lambda o: o[1]):
            if not top or s >= top[-1][1] + top[-1][2]:
                top.append((name, s, d))
        starts = [o[1] for o in top]
        acc = collections.Counter()
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge <= gs:
                continue
            probe = ge - 0.5
            span = min((s for s in self.spans if s[1] <= probe < s[1] + s[2]),
                       key=lambda s: s[2], default=("outside", 0, 0))[0]
            i = bisect.bisect_right(starts, probe) - 1
            op = (top[i][0] if i >= 0 and probe < top[i][1] + top[i][2]
                  else "python")
            acc[f"{span}/{op}"] += (ge - gs) / 1e6
        return [[k, v] for k, v in acc.most_common(n)]


def profile(block, path: str) -> Profile:
    """Run ``block()`` under the profiler and reduce its trace; the trace
    file at ``path`` is removed afterwards."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        block()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)
    dev, spans, ops, fams = [], [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name", "")
        item = (name, float(e["ts"]), float(e["dur"]))
        if cat in DEVICE_CATS:
            if name not in fams:
                fams[name] = family(name)
            dev.append((fams[name],) + item[1:])
        elif cat == "user_annotation":
            spans.append(item)
        elif cat == "cpu_op":
            ops.append(item)
    reqs = [s for s in spans if s[0] == REQUEST_SPAN]
    if not reqs:
        raise RuntimeError("the profiled block recorded no request span")
    t0 = min(s[1] for s in reqs)
    t1 = max(s[1] + s[2] for s in reqs)
    return Profile(t0=t0, t1=t1, device=dev, spans=spans, host_ops=ops,
                   requests=len(reqs))
