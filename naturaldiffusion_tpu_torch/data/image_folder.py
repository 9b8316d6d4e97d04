"""Image-folder preprocessing (the numpy and PIL part of
``naturaldiffusion_tpu/data/image_folder.py``): CelebA/LSUN-style crops and
resizes over a directory of images, the reference's per-dataset TFDS
preprocessing (``deps/score_sde_pytorch/datasets.py:44-139``) without TFDS.

* CelebA: ``central_crop(140)`` then ``resize_small(image_size)``;
* LSUN at 128px: ``resize_small(size)`` then ``central_crop(size)``;
* LSUN >128 / CelebA-HQ-from-images: ``crop_resize``, the central square
  crop to the short side, then an antialiased bicubic resize;
* plain: a bilinear resize.

``apps.degradation`` VAE-encodes such a folder; :func:`image_folder_iterator`
is the shuffled training iterator.  PIL is imported where an image is
opened.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def list_images(data_dir: str) -> list[str]:
    files = []
    for ext in _EXTS:
        files += glob.glob(os.path.join(data_dir, "**", f"*{ext}"),
                           recursive=True)
    return sorted(files)


def _central_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _resize_small(img, size: int):
    """Scale so the SHORT side == size, preserving aspect ratio
    (reference ``resize_small``)."""
    from PIL import Image
    w, h = img.size
    ratio = size / min(w, h)
    return img.resize((round(w * ratio), round(h * ratio)),
                      Image.Resampling.BILINEAR)


def preprocess_image(img, image_size: int, mode: str = "resize"):
    """PIL image -> float32 HWC in [0, 1] with the reference semantics."""
    from PIL import Image
    img = img.convert("RGB")
    if mode == "celeba":                 # central_crop(140) -> resize_small
        img = _central_crop(img, 140)
        img = _resize_small(img, image_size)
        img = _central_crop(img, image_size)     # ratio rounding guard
    elif mode == "lsun_small":           # resize_small -> central_crop
        img = _resize_small(img, image_size)
        img = _central_crop(img, image_size)
    elif mode == "crop_resize":          # central square -> resize
        # the reference's crop_resize (LSUN >128 / CelebA-HQ) resizes
        # BICUBIC with antialias (tf.image.resize(method=BICUBIC,
        # antialias=True)); BILINEAR here shifted the training
        # distribution slightly
        img = _central_crop(img, min(img.size))
        img = img.resize((image_size, image_size),
                         Image.Resampling.BICUBIC)
    elif mode == "resize":
        img = img.resize((image_size, image_size),
                         Image.Resampling.BILINEAR)
    else:
        raise ValueError(mode)
    return np.asarray(img, np.float32) / 255.0


def image_folder_iterator(data_dir: str, batch_size: int, *,
                          image_size: int, mode: str = "resize",
                          random_flip: bool = True, centered: bool = True,
                          seed: int = 0,
                          cache: bool = True,
                          cache_max_bytes: int = 2 << 30) -> Iterator:
    """Infinite shuffled (images in model space, labels=zeros) batches over
    every image file under ``data_dir`` (recursive), the JAX iterator's
    draws from ``numpy.random.default_rng(seed)``: indices, then flips.
    Decoded images are kept as uint8 up to ``cache_max_bytes``."""
    from PIL import Image

    from .datasets import get_scaler

    files = list_images(data_dir)
    if not files:
        raise FileNotFoundError(f"no images under {data_dir!r}")
    rng = np.random.default_rng(seed)
    scaler = get_scaler(centered)
    # a bounded uint8 cache: LSUN-scale folders would otherwise grow an
    # unbounded float32 dict
    cached: dict[int, np.ndarray] = {}
    cache_budget = int(cache_max_bytes // (image_size * image_size * 3))

    def load(i: int) -> np.ndarray:
        if cache and i in cached:
            return cached[i].astype(np.float32) / 255.0
        with Image.open(files[i]) as im:
            arr = preprocess_image(im, image_size, mode)
        if cache and len(cached) < cache_budget:
            cached[i] = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        return arr

    while True:
        idx = rng.integers(0, len(files), batch_size)
        imgs = np.stack([load(int(i)) for i in idx])
        if random_flip:
            flip = rng.random(batch_size) < 0.5
            imgs[flip] = imgs[flip, :, ::-1]
        yield scaler(imgs), np.zeros(batch_size, np.int32)
