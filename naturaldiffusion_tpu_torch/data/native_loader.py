"""The batch loader of the FID statistics pipeline (port of
``naturaldiffusion_tpu/data/native_loader.py``).

The JAX package gathers records with a C++ loader (a prefetch thread and a
multithreaded fill) and falls back to numpy where no compiler exists.  The
port's one caller, ``apps/fid_stats.py``, reads the dataset once, in order,
a batch at a time, and the Inception forward on the card takes the time, so
the port keeps the numpy path alone: the whole files read with
``np.fromfile``, a batch gathered by indexing.  The class keeps the JAX
name and its ``gather``, ``next_batch``, ``__len__`` and ``backend``.
"""

from __future__ import annotations

import numpy as np


class NativeBatchLoader:
    """float32 batches out of uint8 record files (CIFAR-10 binary layout by
    default).  ``gather(indices)`` and ``next_batch(n)`` (random indices
    and flips from ``seed``) return ``([n, h, w, c] in [0, 1], [n] int32
    labels)``, the label being a record's last label byte.  ``backend`` is
    ``"numpy"``, the JAX loader's name for this path."""

    backend = "numpy"

    def __init__(self, paths: list[str], *, label_bytes: int = 1, c: int = 3,
                 h: int = 32, w: int = 32, seed: int = 0):
        self.shape = (h, w, c)
        self.label_bytes = label_bytes
        self.rng = np.random.default_rng(seed)
        rec_len = label_bytes + c * h * w
        self._records = np.concatenate(
            [np.fromfile(p, dtype=np.uint8).reshape(-1, rec_len)
             for p in paths])

    def __len__(self) -> int:
        return len(self._records)

    def gather(self, indices, hflip=None):
        """Records ``indices`` (each in ``[0, len)``), flipped left-right
        where ``hflip`` is non-zero."""
        idx = np.asarray(indices, np.int64)
        n = len(idx)
        if n and (idx.min() < 0 or idx.max() >= len(self)):
            raise IndexError(f"record index out of [0, {len(self)})")
        h, w, c = self.shape
        rec = self._records[idx]
        lb = self.label_bytes
        labels = rec[:, lb - 1].astype(np.int32)
        images = (rec[:, lb:].reshape(n, c, h, w).transpose(0, 2, 3, 1)
                  .astype(np.float32) / 255.0)
        if hflip is not None:
            f = np.asarray(hflip).astype(bool)
            images[f] = images[f][:, :, ::-1]
        return images, labels

    def next_batch(self, batch_size: int, *, random_flip: bool = True):
        idx = self.rng.integers(0, len(self), batch_size)
        flip = (self.rng.random(batch_size) < 0.5).astype(np.uint8) \
            if random_flip else None
        return self.gather(idx, flip)
