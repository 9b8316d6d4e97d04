"""The program's own spans (``naturaldiffusion_tpu_torch.utils.profiling.
span``), read by the per-layer metrics of the layers they time.

Importing this module turns the spans on.  Only those metrics' files import
it, and the run loads a cell's per-layer readers, before it makes the
system, in ``--trace 1`` runs alone: there the spans record the set-up's
warm request, the whole untraced window and the profiled request, and a
``--trace 0`` run never has them on.  Where the program has no spans (a
checkout older than them) nothing is turned on and every reader returns
None.  The record is the process's, and a process runs one cell.
"""

from __future__ import annotations

import bisect
import statistics

try:
    from naturaldiffusion_tpu_torch.utils import profiling as _profiling
except ImportError:
    _profiling = None

ON = _profiling is not None and hasattr(_profiling, "set_spans")
if ON:
    _profiling.set_spans(True)


def median_ms(name):
    """Median milliseconds of the recorded ``name`` spans on the card (its
    CUDA events; in a run without CUDA, the CPU rehearsals, the host clock,
    which there times the same work).  None where the span never ran."""
    if not ON:
        return None
    runs = _profiling.span_record().get(name, [])
    vals = [r.host_s if r.device_s is None else r.device_s for r in runs]
    return statistics.median(vals) * 1e3 if vals else None


def ops_per_span(profile, name):
    """Mean count of outermost host operators (``cpu_op`` events; an
    operator inside another counts once) inside each ``name`` span of the
    traced stretch (``harness.trace.Profile``).  None where it has none."""
    if profile is None:
        return None
    spans = [(s, s + d) for n, s, d in profile.spans if n == name]
    if not spans:
        return None
    ops = sorted((s, s + d) for _, s, d in profile.host_ops)
    starts = [s for s, _ in ops]
    counts = []
    for a, b in spans:
        n, end = 0, float("-inf")
        for s, e in ops[bisect.bisect_left(starts, a):]:
            if s >= b:
                break
            if e <= b and s >= end:
                n, end = n + 1, e
        counts.append(n)
    return statistics.fmean(counts)
