"""Scalar metrics writer (port of ``naturaldiffusion_tpu/utils/metrics.py``).

The reference's score_sde substrate logs through a TensorBoard
``SummaryWriter`` (``deps/score_sde_pytorch/run_lib.py:60-62,133-136``).
This writer does both:

* TensorBoard event files via ``tensorboardX`` where it imports (not on
  every machine; the JSONL file is always written);
* always a ``metrics.jsonl`` (one ``{"step", "tag", "value", "time"}``
  record per scalar), machine-readable without TensorBoard.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                           buffering=1)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:          # tensorboardX absent: JSONL only
            pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"step": int(step), "tag": tag, "value": float(value),
               "time": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
