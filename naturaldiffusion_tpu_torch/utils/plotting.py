"""Plot and image-grid helpers (port of ``naturaldiffusion_tpu/utils/
plotting.py``: the reference's marginal plot, ``src/Utils.py:14-27``, and
torchvision ``save_image`` grids).  Both import their library (PIL,
matplotlib) when called, so importing this module needs neither."""

from __future__ import annotations

import os

import numpy as np


def draw_marginal_coeff(matrix, path: str) -> None:
    """Ideal against equivalent signal and noise marginal curves of a
    ``CoeffMatrix`` (reference ``src/Utils.py:14-27``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = matrix.node[1:, 0]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(ts, matrix.node[1:, 1], label="ideal signal", lw=2)
    ax.plot(ts, matrix.x0.sum(axis=1), "--", label="equivalent signal")
    ax.plot(ts, matrix.node[1:, 2], label="ideal noise", lw=2)
    ax.plot(ts, np.linalg.norm(matrix.eps, axis=1), "--",
            label="equivalent noise")
    ax.set_xlabel("t")
    ax.legend()
    if ts[0] > ts[-1]:
        ax.invert_xaxis()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_image_grid(images, path: str, nrow: int = 8,
                    value_range=(-1.0, 1.0)) -> None:
    """[N, H, W, C] float (numpy or a tensor) -> one PNG grid, ``nrow``
    images a row (the torchvision ``save_image`` twin)."""
    from PIL import Image

    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    lo, hi = value_range
    imgs = np.clip((np.asarray(images, np.float32) - lo) / (hi - lo), 0, 1)
    n, h, w, c = imgs.shape
    nr = -(-n // nrow)
    grid = np.zeros((nr * h, nrow * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    arr = (grid * 255).astype(np.uint8)
    if c == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)
