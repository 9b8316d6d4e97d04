"""Dataset pipelines (port of ``naturaldiffusion_tpu/data/datasets.py``:
the reference's ``deps/score_sde_pytorch/datasets.py:23-196`` without
TFDS).

* :func:`get_scaler` / :func:`get_inverse_scaler`: the centered and [0, 1]
  data maps.
* :func:`cifar10_iterator`: an endless shuffled batch iterator over the
  CIFAR-10 binary files with the reference's random flips
  (``datasets.py:123-130``), on the port's numpy loader
  (``data/native_loader.py``).  JAX's C++ loader prefetches the next batch
  on a thread; its batches are ``next_batch``'s, from the same random
  stream, so the two yield the same batches.
* :func:`svhn_iterator`: SVHN's ``.mat`` release (read by
  :func:`load_svhn_mat`, a MATLAB v5 reader in numpy and zlib).
* :func:`synthetic_iterator`: a stand-in of the right shape when no data
  is on disk.
* :func:`get_dataset`: the registry, with the folder and TFRecord routing
  of the non-CIFAR datasets.

Every iterator draws from ``numpy.random.default_rng(seed)`` in the JAX
package's order, so it yields the JAX iterator's batches.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import Iterator

import numpy as np

from ..scaler import get_inverse_scaler
from .native_loader import NativeBatchLoader

__all__ = ["get_scaler", "get_inverse_scaler", "cifar10_iterator",
           "load_svhn_mat", "svhn_iterator", "synthetic_iterator",
           "get_dataset"]


def get_scaler(centered: bool = True):
    """[0,1] -> model space (reference ``datasets.py:36-42``)."""
    return (lambda x: x * 2.0 - 1.0) if centered else (lambda x: x)


def cifar10_iterator(data_dir: str, batch_size: int, *,
                     split: str = "train", centered: bool = True,
                     random_flip: bool = True, seed: int = 0) -> Iterator:
    """Yields (images [B,32,32,3] in model space, labels [B]) forever.

    ``data_dir`` holds the CIFAR-10 *binary* release (cifar-10-batches-bin):
    data_batch_{1..5}.bin / test_batch.bin."""
    pattern = "data_batch_*.bin" if split == "train" else "test_batch.bin"
    paths = sorted(glob.glob(os.path.join(data_dir, pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no CIFAR-10 binary files under {data_dir!r} ({pattern})")
    loader = NativeBatchLoader(paths, seed=seed)
    scaler = get_scaler(centered)
    while True:
        images, labels = loader.next_batch(batch_size,
                                           random_flip=random_flip)
        yield scaler(images), labels


# -- SVHN's MATLAB v5 release ----------------------------------------------

# MATLAB data types: numpy dtype by type code
_MI = {1: "i1", 2: "u1", 3: "<i2", 4: "<u2", 5: "<i4", 6: "<u4", 7: "<f4",
       9: "<f8", 12: "<i8", 13: "<u8"}
_MI_MATRIX, _MI_COMPRESSED = 14, 15
# array classes: the dtype ``scipy.io.loadmat`` returns
_MX = {6: np.float64, 7: np.float32, 8: np.int8, 9: np.uint8, 10: np.int16,
       11: np.uint16, 12: np.int32, 13: np.uint32, 14: np.int64,
       15: np.uint64}


def _elements(buf: bytes, pos: int = 0):
    """(type, data bytes) of each data element of a little-endian v5
    stream from ``pos``; a compressed element is inflated and walked."""
    while pos + 8 <= len(buf):
        mtype, nbytes = struct.unpack_from("<II", buf, pos)
        if mtype >> 16:                      # small element: data in-tag
            yield mtype & 0xFFFF, buf[pos + 4:pos + 4 + (mtype >> 16)]
            pos += 8
            continue
        data = buf[pos + 8:pos + 8 + nbytes]
        if mtype == _MI_COMPRESSED:
            yield from _elements(zlib.decompress(data))
            pos += 8 + nbytes
            continue
        yield mtype, data
        pos += 8 + nbytes + (-nbytes % 8)


def _matrix(data: bytes):
    """(name, array) of one miMATRIX element: flags, dimensions, name, the
    real part in column-major order, cast to the array's class."""
    sub = list(_elements(data))
    cls = struct.unpack_from("<I", sub[0][1])[0] & 0xFF
    dims = np.frombuffer(sub[1][1], "<i4").tolist()
    name = sub[2][1].decode("ascii")
    if cls not in _MX:
        return name, None                    # cells, structs, sparse: skip
    mtype, raw = sub[3]
    arr = np.frombuffer(raw, _MI[mtype]).reshape(dims, order="F")
    return name, arr.astype(_MX[cls])


def _loadmat(path: str) -> dict:
    """The numeric arrays of a MATLAB v5 ``.mat`` file by name."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[126:128] != b"IM":
        raise ValueError(f"{path}: not a little-endian MATLAB v5 file")
    out = {}
    for mtype, data in _elements(buf, 128):
        if mtype == _MI_MATRIX:
            name, arr = _matrix(data)
            if arr is not None:
                out[name] = arr
    return out


def load_svhn_mat(path: str) -> tuple[np.ndarray, np.ndarray]:
    """SVHN cropped-digits ``.mat`` (train_32x32.mat layout) ->
    (images [N,32,32,3] uint8, labels [N] int32 with 10 -> 0).

    The reference consumes SVHN via TFDS ``svhn_cropped``
    (``deps/score_sde_pytorch/datasets.py:82-96``); the local form is
    Stanford's MATLAB release: X [32,32,3,N], y [N,1] (digit '0' stored as
    class 10)."""
    m = _loadmat(path)
    images = np.ascontiguousarray(np.transpose(m["X"], (3, 0, 1, 2)))
    labels = m["y"].reshape(-1).astype(np.int32) % 10
    return images, labels


def svhn_iterator(data_dir: str, batch_size: int, *, split: str = "train",
                  centered: bool = True, seed: int = 0) -> Iterator:
    """Infinite shuffled (images in model space, labels) batches over the
    SVHN .mat release.  No flip augmentation: flipped digits are different
    glyphs, as TFDS's un-augmented svhn_cropped."""
    path = os.path.join(data_dir, f"{split}_32x32.mat")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    images, labels = load_svhn_mat(path)
    rng = np.random.default_rng(seed)
    scaler = get_scaler(centered)
    n = len(images)

    while True:
        idx = rng.integers(0, n, batch_size)
        yield (scaler(images[idx].astype(np.float32) / 255.0),
               labels[idx])


def synthetic_iterator(batch_size: int, *, shape=(32, 32, 3),
                       num_classes: int = 10, centered: bool = True,
                       seed: int = 0) -> Iterator:
    rng = np.random.default_rng(seed)
    scaler = get_scaler(centered)

    while True:
        imgs = rng.random((batch_size,) + tuple(shape), np.float32)
        labels = rng.integers(0, num_classes, batch_size).astype(np.int32)
        yield scaler(imgs), labels


# dataset -> default image size, for the reference's non-CIFAR datasets
# (datasets.py:44-139 semantics)
_FOLDER_DATASETS = {
    "celeba": 64,
    "lsun": 256,
    "church": 256,
    "bedroom": 128,
    "celebahq": 256,
}


def _folder_mode(name: str, size: int) -> str:
    if name == "celeba":
        return "celeba"
    # reference LSUN semantics are size-dependent (datasets.py:127-139):
    # 128px = resize_small -> central_crop; larger = central crop_resize
    if name in ("lsun", "church", "bedroom"):
        return "lsun_small" if size == 128 else "crop_resize"
    return "crop_resize"


def get_dataset(name: str, batch_size: int, *, data_dir: str | None = None,
                centered: bool = True, image_size: int | None = None,
                **kw) -> Iterator:
    """Registry entry point (reference ``get_dataset``, ``datasets.py:71``).

    * ``cifar10`` -- the binary release;
    * ``celeba``/``lsun``/``church``/``bedroom``/``celebahq`` -- an image
      directory with the reference's crop/resize mode, or ``.tfrecords``
      files through the numpy TFRecord reader;
    * ``ffhq`` -- TFRecords (the reference's only FFHQ form);
    * ``svhn`` -- the ``.mat`` release;
    * ``synthetic`` -- the stand-in.
    Falls back to synthetic at the right shape when ``data_dir`` is empty.
    """
    if name not in ("cifar10", "svhn"):
        kw.pop("split", None)
    if name == "cifar10":
        if data_dir and glob.glob(os.path.join(data_dir, "*_batch*.bin")):
            return cifar10_iterator(data_dir, batch_size, centered=centered,
                                    **kw)
        return synthetic_iterator(batch_size, shape=(32, 32, 3),
                                  centered=centered)
    if name in _FOLDER_DATASETS or name == "ffhq":
        size = image_size or _FOLDER_DATASETS.get(name, 256)
        mode = _folder_mode(name, size)
        if data_dir:
            recs = glob.glob(os.path.join(data_dir, "*.tfrecord*"))
            if recs or name == "ffhq":
                from .tfrecord import tfrecord_iterator
                return tfrecord_iterator(sorted(recs), batch_size,
                                         centered=centered, **kw)
            from .image_folder import image_folder_iterator, list_images
            if list_images(data_dir):
                return image_folder_iterator(
                    data_dir, batch_size, image_size=size, mode=mode,
                    centered=centered, **kw)
        return synthetic_iterator(batch_size, shape=(size, size, 3),
                                  centered=centered)
    if name == "svhn":
        split = kw.pop("split", "train")
        kw.pop("random_flip", None)            # digits are never flipped
        if data_dir and os.path.exists(
                os.path.join(data_dir, f"{split}_32x32.mat")):
            return svhn_iterator(data_dir, batch_size, split=split,
                                 centered=centered, **kw)
        return synthetic_iterator(batch_size, shape=(32, 32, 3),
                                  centered=centered)
    if name == "synthetic":
        return synthetic_iterator(batch_size, centered=centered, **kw)
    raise ValueError(f"unknown dataset {name!r}")
