"""The port's training data paths against the JAX package's, batch for
batch on files the test writes: the CIFAR-10 binary iterator (JAX's C++
loader and its numpy path), SVHN's ``.mat`` release (plain and compressed,
read by the port's own MATLAB v5 reader), the TFRecord reader and
iterator, the image-folder iterator, the synthetic stand-in, the
``get_dataset`` routing, and the metrics writer."""

import json
import struct

import numpy as np
import pytest

import torch_port_util  # noqa: F401  binds torch's CPU math first
from naturaldiffusion_tpu.data import datasets as jds
from naturaldiffusion_tpu.data import tfrecord as jtf
from naturaldiffusion_tpu_torch.data import datasets as tds
from naturaldiffusion_tpu_torch.data import tfrecord as ttf


def _take(it, n):
    return [next(it) for _ in range(n)]


def _same_batches(a, b, atol=0.0):
    assert len(a) == len(b)
    for (xa, la), (xb, lb) in zip(a, b):
        assert xa.shape == xb.shape and xa.dtype == xb.dtype
        np.testing.assert_allclose(xa, xb, rtol=0, atol=atol)
        np.testing.assert_array_equal(la, lb)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("cifar")
    for name, n in (("data_batch_1.bin", 40), ("data_batch_2.bin", 30),
                    ("test_batch.bin", 20)):
        rec = np.empty((n, 1 + 3072), np.uint8)
        rec[:, 0] = rng.integers(0, 10, n)
        rec[:, 1:] = rng.integers(0, 256, (n, 3072))
        rec.tofile(d / name)
    return str(d)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("centered,flip", [(True, True), (False, False)])
@pytest.mark.parametrize("force_numpy", [True, False])
def test_cifar10_iterator_matches_jax(cifar_dir, split, centered, flip,
                                      force_numpy):
    """The port's batches equal JAX's numpy path bit for bit, and JAX's C++
    loader (with its prefetch) within the 1e-7 its own test allows between
    its two backends (the C++ fill rounds x / 255 another way; 2e-7 after
    the centered scaler's x 2), 4 batches of 16 with the same records and
    flips."""
    want = _take(jds.cifar10_iterator(
        cifar_dir, 16, split=split, centered=centered, random_flip=flip,
        seed=3, force_numpy=force_numpy), 4)
    got = _take(tds.cifar10_iterator(cifar_dir, 16, split=split,
                                     centered=centered, random_flip=flip,
                                     seed=3), 4)
    _same_batches(got, want, atol=0.0 if force_numpy
                  else 2e-7 if centered else 1e-7)


def test_cifar10_iterator_needs_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(tds.cifar10_iterator(str(tmp_path), 4))


@pytest.mark.parametrize("compress", [False, True])
def test_svhn_matches_jax(tmp_path, compress):
    from scipy.io import savemat
    rng = np.random.default_rng(1)
    X = rng.integers(0, 256, (32, 32, 3, 20), dtype=np.uint8)
    y = np.concatenate([rng.integers(1, 10, 19), [10]]).reshape(-1, 1)
    savemat(tmp_path / "train_32x32.mat", {"X": X, "y": y},
            do_compression=compress)
    path = str(tmp_path / "train_32x32.mat")
    gi, gl = tds.load_svhn_mat(path)
    wi, wl = jds.load_svhn_mat(path)
    assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert gl[-1] == 0
    _same_batches(_take(tds.get_dataset("svhn", 8, data_dir=str(tmp_path)),
                        3),
                  _take(jds.get_dataset("svhn", 8, data_dir=str(tmp_path)),
                        3))


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _example(img: np.ndarray) -> bytes:
    """A tf.train.Example {shape: int64[3], data: bytes} in protobuf wire
    format (packed int64 list)."""
    shape = _field(3, _field(1, b"".join(_varint(s) for s in img.shape)))
    data = _field(1, _field(1, img.tobytes()))
    feats = (_field(1, _field(1, b"shape") + _field(2, shape))
             + _field(1, _field(1, b"data") + _field(2, data)))
    return _field(1, feats)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfr")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
            for _ in range(6)]
    path = d / "ffhq-r03.tfrecords"
    with open(path, "wb") as fh:
        for img in imgs:
            rec = _example(img)
            fh.write(struct.pack("<Q", len(rec)) + b"\0" * 4 + rec
                     + b"\0" * 4)
        fh.write(struct.pack("<Q", 99) + b"\0" * 6)     # a truncated tail
    return str(d), str(path), imgs


def test_tfrecord_reader_matches_jax(records):
    _, path, imgs = records
    got = list(ttf.iter_tfrecord(path))
    assert got == list(jtf.iter_tfrecord(path)) and len(got) == 6
    assert ttf.parse_example(got[0]) == jtf.parse_example(got[0])
    for a, b, img in zip(ttf.load_chw_image_records([path]),
                         jtf.load_chw_image_records([path]), imgs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, img.transpose(1, 2, 0))
    assert ttf.index_tfrecords([path]) == jtf.index_tfrecords([path])


@pytest.mark.parametrize("dequant", [False, True])
def test_tfrecord_iterator_matches_jax(records, dequant):
    _, path, _ = records
    kw = dict(uniform_dequantization=dequant, seed=4)
    _same_batches(_take(ttf.tfrecord_iterator([path], 5, **kw), 3),
                  _take(jtf.tfrecord_iterator([path], 5, **kw), 3))
    _same_batches(_take(tds.get_dataset("ffhq", 4, data_dir=records[0]), 2),
                  _take(jds.get_dataset("ffhq", 4, data_dir=records[0]), 2))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(((180, 150), (64, 96), (160, 160))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(d / f"im{i}.png")
    return str(d)


@pytest.mark.parametrize("name,size", [("celeba", 32), ("bedroom", 128),
                                       ("church", 64), ("celebahq", 16)])
def test_image_folder_matches_jax(folder, name, size):
    """``get_dataset``'s folder routing (each preprocessing mode) and the
    iterator's draws, against JAX's."""
    _same_batches(
        _take(tds.get_dataset(name, 4, data_dir=folder, image_size=size), 3),
        _take(jds.get_dataset(name, 4, data_dir=folder, image_size=size), 3))


def test_synthetic_and_fallbacks_match_jax():
    _same_batches(_take(tds.get_dataset("synthetic", 3, seed=7), 2),
                  _take(jds.get_dataset("synthetic", 3, seed=7), 2))
    for name in ("cifar10", "celeba", "lsun"):
        a = next(tds.get_dataset(name, 2, data_dir=None))
        b = next(jds.get_dataset(name, 2, data_dir=None))
        assert a[0].shape == b[0].shape
        np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.get_dataset("mnist", 2)


def test_scalers_match_jax():
    x = np.linspace(0, 1, 7, dtype=np.float32)
    for c in (True, False):
        np.testing.assert_array_equal(tds.get_scaler(c)(x),
                                      jds.get_scaler(c)(x))
        np.testing.assert_array_equal(tds.get_inverse_scaler(c)(x),
                                      jds.get_inverse_scaler(c)(x))


def test_metrics_writer_matches_jax(tmp_path):
    from naturaldiffusion_tpu.utils.metrics import MetricsWriter as JW
    from naturaldiffusion_tpu_torch.utils.metrics import MetricsWriter as TW
    for cls, d in ((TW, tmp_path / "port"), (JW, tmp_path / "jax")):
        w = cls(str(d))
        w.scalar("training_loss", 0.5, 3)
        w.scalar("img_per_sec", 12.0, 4)
        w.close()

    def recs(d):
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in open(d / "metrics.jsonl")]
    assert recs(tmp_path / "port") == recs(tmp_path / "jax")
    assert recs(tmp_path / "port")[0] == {"step": 3, "tag": "training_loss",
                                          "value": 0.5}
