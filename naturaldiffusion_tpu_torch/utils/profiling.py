"""Timing and tracing (port of ``naturaldiffusion_tpu/utils/profiling.py``).

* :class:`Timer` -- the median time of a call: CUDA events on the card,
  ``time.perf_counter`` on the CPU, after a warm-up, synchronised.
* :func:`trace` -- a ``torch.profiler`` context that writes a Chrome trace,
  which :mod:`.trace_summary` reads.
* :class:`NFECounter` -- wrap a denoiser to count network function
  evaluations.
"""

from __future__ import annotations

import contextlib
import os
import socket
import statistics
import time
from typing import Callable

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
    kernel."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json"))


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
