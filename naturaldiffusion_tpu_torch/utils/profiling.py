"""Timing and tracing (port of ``naturaldiffusion_tpu/utils/profiling.py``).

* :class:`Timer` -- the median time of a call: CUDA events on the card,
  ``time.perf_counter`` on the CPU, after a warm-up, synchronised.
* :func:`trace` -- a ``torch.profiler`` context that writes a Chrome trace,
  which :mod:`.trace_summary` reads.
* :func:`span` -- a named span at one of the port's layer boundaries, off
  by default; :func:`set_spans` turns the spans on, :func:`span_record`
  reads what they recorded.
* :class:`NFECounter` -- wrap a denoiser to count network function
  evaluations.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import socket
import statistics
import threading
import time
from typing import Callable, NamedTuple

import torch

from ..device import resolve_device


class Timer:
    """``Timer()(fn, *args)`` -> the median seconds of ``iters`` calls
    after one warm-up call.  On ``device="cuda"`` (the default, which needs
    a card) each call is timed with CUDA events around it and synchronised,
    so the time is the card's; on ``device="cpu"`` with the host clock."""

    def __init__(self, iters: int = 5, device="cuda"):
        self.iters = iters
        self.device = resolve_device(device)
        self.times: list[float] = []

    def once(self, fn: Callable, *args, **kwargs) -> float:
        """Seconds of one call of ``fn``, synchronised."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device):
            start.record()
            fn(*args, **kwargs)
            end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def __call__(self, fn: Callable, *args, **kwargs) -> float:
        self.once(fn, *args, **kwargs)                  # warm-up
        self.times = [self.once(fn, *args, **kwargs)
                      for _ in range(self.iters)]
        return statistics.median(self.times)


# Idle seconds the profiled window keeps on the card before and after the
# block.  A trace of CUDA-graph replays whose block ran flush against the
# window's edges has come back without kernels of its first and last steps
# (an H100, 5 and 22 of 2,080 launches of the port's kernels); the pad keeps
# the block's kernels away from the edges.
TRACE_PAD_S = 0.1


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a block (CPU activity, and the card's when
    one exists), written into ``logdir`` as a Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json``.  On the card the window starts
    TRACE_PAD_S before the block and ends TRACE_PAD_S after its last
    kernel.  The port's spans (:func:`span`) are on inside the block, so
    the trace holds them too; their previous state returns after it."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = set_spans(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
            yield
            if cuda:
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
    finally:
        set_spans(was_on)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json"))


# -- spans at the port's layer boundaries -----------------------------------

SPAN_KEEP = 4096        # the newest records kept of each span name


class SpanRecord(NamedTuple):
    """One run of a span.  ``host_s``: its seconds on the host clock.
    ``device_s``: its seconds on the card, from the current stream reaching
    its start to the stream's last work in it (a pair of CUDA events);
    None where the process had not initialised CUDA.  ``parent``: the name
    of the span it ran in, None if outermost.  ``outer``: the number of the
    outermost span it ran in (its own if outermost), which the spans of
    one call share."""

    host_s: float
    device_s: float | None
    parent: str | None
    outer: int


class _Spans:
    """The spans' state, one for the process, since the spans sit deep in
    the models where nothing is passed down: on or off, the records by
    name (each run a list ``[host_s, device_s, parent, outer, events]``),
    the runs whose events the card has not passed, the free event pairs,
    and one stack of open spans per thread."""

    def __init__(self):
        self.on = False
        self.records = collections.defaultdict(
            lambda: collections.deque(maxlen=SPAN_KEEP))
        self.pending: collections.deque = collections.deque()
        self.pool: list = []
        self.numbers = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def events(self):
        """A free pair of timing events; under ``lock``."""
        if self.pool:
            return self.pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def reap(self, wait: bool):
        """The device seconds of the pending runs, oldest first, their
        events back to the pool: the runs the card has passed, or with
        ``wait`` (after a synchronize) all.  Under ``lock``."""
        while self.pending:
            run = self.pending[0]
            start, end = run[4]
            if not wait and not end.query():
                break
            self.pending.popleft()
            run[1] = start.elapsed_time(end) / 1e3
            run[4] = None
            self.pool.append((start, end))


_SPANS = _Spans()
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One open span (see :func:`span`)."""

    __slots__ = ("name", "prof", "run", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prof = self.run = None
        if torch.autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return self         # a capture takes no clock and no event
        st = _SPANS.stack()
        parent, outer = ((st[-1].name, st[0].run[3]) if st
                         else (None, next(_SPANS.numbers)))
        self.run = [0.0, None, parent, outer, None]
        st.append(self)
        if cuda:
            with _SPANS.lock:
                self.run[4] = _SPANS.events()
            self.run[4][0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        run = self.run
        if run is not None:
            run[0] = (time.perf_counter_ns() - self.t0) / 1e9
            _SPANS.stack().pop()
            with _SPANS.lock:
                _SPANS.records[self.name].append(run)
                if run[4] is not None:
                    run[4][1].record()
                    _SPANS.pending.append(run)
                    _SPANS.reap(wait=False)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that times its block as the span ``name``.

    Off (the default) it is one shared no-op: no clock, no allocation, no
    record.  On (:func:`set_spans`) it records the block's host seconds
    (``time.perf_counter_ns``), and where the process has initialised CUDA
    a pair of timing events on the current stream, from a pool; and while
    the autograd profiler runs it enters ``record_function(name)``, so the
    trace holds the span on the kernels' clock.  On a stream that a CUDA
    graph is capturing only the profiler's part runs.  Nothing a span does
    changes a result."""
    return _Span(name) if _SPANS.on else _NO_SPAN


def set_spans(on: bool) -> bool:
    """Turn the spans on or off; returns the previous state."""
    was_on, _SPANS.on = _SPANS.on, bool(on)
    return was_on


def span_record() -> dict[str, list[SpanRecord]]:
    """The spans recorded so far by name, oldest first, the newest
    SPAN_KEEP of each; one synchronize first if some device times are
    pending."""
    with _SPANS.lock:
        if _SPANS.pending:
            torch.cuda.synchronize()
            _SPANS.reap(wait=True)
        return {name: [SpanRecord(*run[:4]) for run in recs]
                for name, recs in _SPANS.records.items()}


def clear_spans():
    """Forget every recorded span."""
    with _SPANS.lock:
        _SPANS.records.clear()


class NFECounter:
    """Counts the calls of a denoiser.  The port runs eagerly, so every
    call is one network function evaluation (NFE); JAX counts call sites
    at trace time instead."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.nfe = 0

    def __call__(self, *args, **kwargs):
        self.nfe += 1
        return self.fn(*args, **kwargs)

    def reset(self):
        self.nfe = 0
