"""Pure-numpy TFRecord + tf.train.Example reader, the FFHQ/CelebAHQ path
(port of ``naturaldiffusion_tpu/data/tfrecord.py``).

The reference consumes FFHQ/CelebAHQ as TFRecords of Examples with features
``{shape: int64[3], data: bytes}`` in CHW uint8 layout
(``deps/score_sde_pytorch/datasets.py:141-163``).  This reader reproduces
that input path without TensorFlow: the TFRecord framing is a simple
length-prefixed format and the Example proto is parsed with a minimal
protobuf wire-format decoder (varint + length-delimited fields, the only
wire types tf.train.Example uses).
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np


# -- protobuf wire format ----------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) over a serialized message.
    value is an int for varint fields, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 0x7
        if wt == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:                    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_feature(buf: bytes):
    """tf.train.Feature: 1=BytesList, 2=FloatList, 3=Int64List."""
    for field, _wt, val in _iter_fields(buf):
        if field == 1:                   # BytesList{repeated bytes value=1}
            out = []
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:
                    out.append(v2)
            return out
        if field == 2:                   # FloatList{repeated float value=1}
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:        # packed
                    return np.frombuffer(v2, "<f4").tolist()
            return []
        if field == 3:                   # Int64List{repeated int64 value=1}
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:        # packed varints
                    vals, p = [], 0
                    while p < len(v2):
                        v, p = _read_varint(v2, p)
                        vals.append(v)
                    return vals
            # unpacked fallback
            return [v2 for f2, w2, v2 in _iter_fields(val)
                    if f2 == 1 and w2 == 0]
    return []


def parse_example(buf: bytes) -> dict:
    """Serialized tf.train.Example -> {name: list-of-values}."""
    feats = {}
    for field, _wt, val in _iter_fields(buf):
        if field != 1:                   # Example.features
            continue
        for f2, _w2, entry in _iter_fields(val):
            if f2 != 1:                  # Features.feature map entry
                continue
            key = None
            fval = None
            for f3, _w3, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    fval = _parse_feature(v3)
            if key is not None:
                feats[key] = fval
    return feats


# -- TFRecord framing --------------------------------------------------------


def _walk_frames(f) -> Iterator[tuple[int, int]]:
    """The one framing walker: yields (payload_offset, payload_length) per
    complete record.  Framing: u64le length, u32 length-crc, payload,
    u32 payload-crc (crcs not verified — the reference pipeline doesn't
    either once TF hands the bytes over).  A truncated tail record (file
    cut mid-payload) is not yielded."""
    end = f.seek(0, 2)
    pos = 0
    while True:
        f.seek(pos)                  # absolute: consumers may seek/read
        head = f.read(8)             # between yields
        if len(head) < 8:
            return
        (length,) = struct.unpack("<Q", head)
        off = pos + 8 + 4            # past the length word + length crc
        if off + length + 4 > end:   # truncated tail
            return
        yield off, length
        pos = off + length + 4       # past the payload + payload crc


def iter_tfrecord(path: str) -> Iterator[bytes]:
    """Yields raw record payloads."""
    with open(path, "rb") as f:
        for off, length in _walk_frames(f):
            f.seek(off)
            yield f.read(length)


def index_tfrecords(paths: list[str]) -> list[tuple[str, int, int]]:
    """One seek-only pass over the framing: (path, payload_offset,
    payload_length) per record.  Payloads are NOT read — FFHQ-1024 is
    ~220 GB decoded, which must never be materialized at once."""
    index = []
    for p in paths:
        with open(p, "rb") as f:
            index.extend((p, off, length) for off, length in _walk_frames(f))
    return index


def _decode_chw_record(rec: bytes) -> np.ndarray:
    ex = parse_example(rec)
    shape = tuple(int(s) for s in ex["shape"])
    data = np.frombuffer(ex["data"][0], np.uint8).reshape(shape)
    return np.transpose(data, (1, 2, 0))


def read_chw_image_record(path: str, offset: int, length: int,
                          file=None) -> np.ndarray:
    """One indexed record -> HWC uint8 (Example features: shape int64[3]
    CHW, data raw bytes; ``datasets.py:152-158`` semantics incl. the
    CHW->HWC transpose).  Pass ``file`` (an open handle for ``path``) to
    skip the per-record open — the training iterator keeps one persistent
    handle per file."""
    if file is not None:
        file.seek(offset)
        return _decode_chw_record(file.read(length))
    with open(path, "rb") as f:
        f.seek(offset)
        return _decode_chw_record(f.read(length))


def load_chw_image_records(paths: list[str]) -> list[np.ndarray]:
    """All records decoded up front — ONLY for small corpora/tests; the
    training iterator goes through :func:`index_tfrecords` + lazy reads."""
    return [read_chw_image_record(*entry) for entry in index_tfrecords(paths)]


def tfrecord_iterator(paths: list[str], batch_size: int, *,
                      random_flip: bool = True, centered: bool = True,
                      uniform_dequantization: bool = False,
                      seed: int = 0,
                      cache_max_bytes: int = 2 << 30) -> Iterator:
    """Infinite shuffled (images in model space, labels=zeros) batches.

    Records are indexed once and decoded lazily per batch with a bounded
    uint8 cache (the ``image_folder_iterator`` policy) — the reference
    streams FFHQ via tf.data for the same reason: fully decoded FFHQ-1024
    is ~220 GB of host RAM."""
    from .datasets import get_scaler

    index = index_tfrecords(paths)
    if not index:
        raise FileNotFoundError(f"no records in {paths!r}")
    rng = np.random.default_rng(seed)
    scaler = get_scaler(centered)
    n = len(index)
    cached: dict[int, np.ndarray] = {}
    budget_left = int(cache_max_bytes)
    # one persistent handle per file: with a corpus far larger than the
    # cache (FFHQ-1024 ~220 GB vs the 2 GB default) nearly every record is
    # a miss, and a per-record open/close would cost a syscall quartet per
    # sample in the training hot loop
    handles = {p: open(p, "rb") for p in paths}

    def load(i: int) -> np.ndarray:
        nonlocal budget_left
        if i in cached:
            return cached[i]
        path, off, length = index[i]
        arr = read_chw_image_record(path, off, length, file=handles[path])
        if arr.nbytes <= budget_left:
            cached[i] = arr
            budget_left -= arr.nbytes
        return arr

    while True:
        idx = rng.integers(0, n, batch_size)
        imgs = np.stack([load(int(i)) for i in idx]).astype(np.float32)
        if uniform_dequantization:
            imgs = (rng.random(imgs.shape, np.float32) + imgs) / 256.0
        else:
            imgs = imgs / 255.0
        if random_flip:
            flip = rng.random(batch_size) < 0.5
            imgs[flip] = imgs[flip, :, ::-1]
        yield scaler(imgs), np.zeros(batch_size, np.int32)
