"""Natural Inference over one micro-batch as one CUDA graph.

The JAX package jits a whole NI run (and ``bench.py`` a map of them) into
one executable, so the host issues it once.  The port runs eagerly, about
a thousand launches per CIFAR step, and the host cannot issue them as fast
as the card runs them.  :class:`GraphedNI` captures one run of
:func:`.ni.natural_inference` with static input buffers into a
``torch.cuda.CUDAGraph`` and replays it: one host call per micro-batch.

* The inputs are static buffers, ``init`` ``[B, ...]`` and, for a
  stochastic schedule, ``noises`` ``[n, B, ...]``, both float32.  The caller
  fills them before each replay (``load``), outside the graph.
* The output is a static tensor as well: the next replay overwrites it, so
  a caller keeps what it needs (a sum, a copy) before replaying again.
* The run is warmed up eagerly on a side stream before the capture.  The
  first launch of each kernel loads its module and sets its attributes,
  which a capture does not allow.
* Every kernel wrapper launches on ``torch.cuda.current_stream()``, which
  is the capture stream inside ``torch.cuda.graph``.
* The kernels' launch counters are Python-side: they count the calls of
  their wrapper, so once at the capture, which launches nothing on the
  card, and never at a replay.  :attr:`GraphedNI.replays` counts the
  replays, and a device trace counts the launches the card ran.
* Whatever the model caches outside the graph is read from the cache's
  memory at each replay: the int8 weights of ``models.layers`` are built
  by the warm-up and rebuilt in place by the first eager call after a
  weight changes, so a replay sees a changed weight only after one.
* A capture that fails raises.  Nothing falls back to the eager loop.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..utils.profiling import span
from .ni import NISchedule, natural_inference


class GraphedNI:
    """``natural_inference(denoise_fn, sched, init, noises=noises, **kw)``
    over ``shape`` images, captured once and replayed.

    ``GraphedNI(fn, sched, shape, prediction_type="eps",
    model_dtype=torch.bfloat16)`` allocates the static buffers and warms the
    run up eagerly.  :meth:`capture` records the graph.  :meth:`load` then
    fills the inputs, and :meth:`replay` returns the static output.
    ``capture_s`` is the capture's wall time.  ``pool_bytes`` is the size
    of the graph's private memory pool: the allocator's segments that
    carry its pool id.  ``replays`` counts the replays."""

    def __init__(self, denoise_fn: Callable, sched: NISchedule, shape,
                 **kwargs):
        dev = sched.x0.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a schedule on a CUDA "
                             f"device, got {dev}")
        self.fn, self.sched, self.kwargs = denoise_fn, sched, kwargs
        self.shape = tuple(shape)
        f32 = torch.float32
        self.init = torch.zeros(self.shape, dtype=f32, device=dev)
        self.noises = (None if sched.deterministic else torch.zeros(
            (sched.num_step,) + self.shape, dtype=f32, device=dev))
        self.graph = None
        self.out = None
        self.capture_s = self.pool_bytes = None
        self.replays = 0
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)

    def _run(self):
        return natural_inference(self.fn, self.sched, self.init,
                                 noises=self.noises, **self.kwargs)

    def capture(self) -> "GraphedNI":
        dev = self.init.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), torch.no_grad():
            self.out = self._run()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        pool = tuple(graph.pool())
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == pool)
        self.graph = graph
        return self

    def load(self, init: torch.Tensor, generator: torch.Generator | None):
        """Copy ``init`` into the static input and draw the noises of a
        stochastic schedule from ``generator`` into the static buffer."""
        self.init.copy_(init)
        if self.noises is not None:
            self.noises.normal_(generator=generator)

    def replay(self) -> torch.Tensor:
        """Run the graph once; the returned tensor is overwritten by the
        next replay."""
        if self.graph is None:
            raise RuntimeError("GraphedNI.replay before capture()")
        with span("graph.replay"):
            self.graph.replay()
        self.replays += 1
        return self.out
