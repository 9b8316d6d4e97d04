"""SentencePiece unigram tokenizer — pure Python, no protobuf/sentencepiece
dependency.  This is the T5 half of the reference's prompt path
(``src/SD3NaturalInference.py:184`` -> ``transformers.T5Tokenizer`` ->
sentencepiece ``spiece.model``).  Copy of ``naturaldiffusion_tpu/text/
spm.py``, kept here so the port never imports the JAX package.

Two parts:

* a minimal protobuf *wire-format* reader for ``ModelProto`` (the
  ``spiece.model`` blob): pieces (string/score/type), normalizer flags and
  the trainer-spec special ids — nothing else is needed for encoding;
* the unigram Viterbi encoder: best-scoring segmentation of the normalized
  text over the piece vocabulary, with sentencepiece's unknown handling
  (an unknown single-char node with ``min_score - 10`` penalty wherever no
  single-char piece matches).

Normalization: when the model carries a ``precompiled_charsmap`` (the
compiled nmt_nfkc rule trie — every T5/SD3 ``spiece.model`` does) it is
interpreted exactly via :mod:`.charsmap`; otherwise ``unicodedata`` NFKC
approximates it.  Whitespace rules (collapse, escape to ``▁`` U+2581,
dummy prefix) follow the model's normalizer flags either way.
"""

from __future__ import annotations

import struct
import unicodedata

import numpy as np

_SP_NORMAL, _SP_UNKNOWN, _SP_CONTROL, _SP_USER, _SP_UNUSED, _SP_BYTE = \
    1, 2, 3, 4, 5, 6
_WS = "▁"          # the sentencepiece whitespace escape


# ---------------------------------------------------------------------------
# protobuf wire format (just enough for ModelProto)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    i = 0
    while i < len(buf):
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_model_proto(data: bytes) -> dict:
    """spiece.model bytes -> {pieces: [(str, score, type)], normalizer
    flags, special ids}."""
    pieces: list[tuple[str, float, int]] = []
    norm = {"add_dummy_prefix": True, "remove_extra_whitespaces": True,
            "escape_whitespaces": True, "precompiled_charsmap": b""}
    ids = {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": -1}

    for field, wire, val in _fields(data):
        if field == 1 and wire == 2:                    # SentencePiece
            piece, score, typ = "", 0.0, _SP_NORMAL
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    typ = v2
            pieces.append((piece, score, typ))
        elif field == 2 and wire == 2:                  # TrainerSpec
            names = {40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}
            for f2, w2, v2 in _fields(val):
                if f2 in names:
                    # ids are int32; -1 arrives as a 10-byte varint
                    ids[names[f2]] = v2 - (1 << 64) if v2 >= (1 << 63) else v2
        elif field == 3 and wire == 2:                  # NormalizerSpec
            flags = {3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
                     5: "escape_whitespaces"}
            for f2, w2, v2 in _fields(val):
                if f2 in flags:
                    norm[flags[f2]] = bool(v2)
                elif f2 == 2 and w2 == 2:       # precompiled_charsmap
                    norm["precompiled_charsmap"] = v2
    return {"pieces": pieces, **norm, **ids}


# ---------------------------------------------------------------------------
# the unigram encoder
# ---------------------------------------------------------------------------


class SentencePieceUnigram:
    """``tok = SentencePieceUnigram.from_file("spiece.model")``;
    ``tok(["a photo of a cat"], max_length=256)`` -> ``[B, L]`` int32 ids
    (ids + EOS, pad-padded — the T5/SD3 conditioning layout)."""

    def __init__(self, pieces: list[tuple[str, float, int]],
                 add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = True,
                 escape_whitespaces: bool = True,
                 unk_id: int = 2, eos_id: int = 1, pad_id: int = 0,
                 precompiled_charsmap: bytes = b""):
        self.pieces = pieces
        if precompiled_charsmap:
            from .charsmap import PrecompiledCharsmap
            self._charsmap = PrecompiledCharsmap(precompiled_charsmap)
        else:
            self._charsmap = None
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        self.unk_id, self.eos_id = unk_id, eos_id
        self.pad_id = pad_id if pad_id >= 0 else 0

        self._match: dict[str, tuple[int, float]] = {}
        # an absent proto `type` field means NORMAL (protobuf default) —
        # accept None-typed pieces the same way
        scores = [s for _, s, t in pieces
                  if t in (_SP_NORMAL, _SP_USER, None)]
        self._min_score = min(scores) if scores else 0.0
        self._unk_score = self._min_score - 10.0   # kUnkPenalty
        self._max_len = 1
        for idx, (piece, score, typ) in enumerate(pieces):
            if typ in (_SP_NORMAL, _SP_USER, None):
                self._match[piece] = (idx, score)
                self._max_len = max(self._max_len, len(piece))

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as fh:
            m = parse_model_proto(fh.read())
        # T5's trainer spec: pad=0 eos=1 unk=2 (bos unused)
        return cls(m["pieces"], add_dummy_prefix=m["add_dummy_prefix"],
                   remove_extra_whitespaces=m["remove_extra_whitespaces"],
                   escape_whitespaces=m["escape_whitespaces"],
                   unk_id=m["unk_id"], eos_id=m["eos_id"],
                   pad_id=m["pad_id"],
                   precompiled_charsmap=m["precompiled_charsmap"])

    # -- normalization -----------------------------------------------------

    def normalize(self, text: str) -> str:
        if self._charsmap is not None:
            # the model's own compiled rule trie (nmt_nfkc) — byte-exact.
            # Post-map, sentencepiece treats only literal ' ' as whitespace.
            text = self._charsmap.normalize(text)
            if self.remove_extra_whitespaces:
                text = " ".join(p for p in text.split(" ") if p)
        else:
            # no charsmap in the proto: NFKC + whitespace-family folding
            # is the documented approximation of nmt_nfkc
            text = unicodedata.normalize("NFKC", text)
            text = "".join(" " if ch.isspace() else ch for ch in text)
            if self.remove_extra_whitespaces:
                text = " ".join(text.split())
        if not text:
            return ""
        if self.add_dummy_prefix:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    # -- Viterbi -----------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        """Token ids WITHOUT specials (best unigram segmentation)."""
        s = self.normalize(text)
        n = len(s)
        if not n:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)   # (start, id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            matched_single = False
            for ln in range(1, min(self._max_len, n - i) + 1):
                hit = self._match.get(s[i:i + ln])
                if hit is None:
                    continue
                if ln == 1:
                    matched_single = True
                idx, score = hit
                cand = best[i] + score
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = (i, idx)
            if not matched_single:
                # sentencepiece: a 1-char unk node wherever no single-char
                # piece covers the position
                cand = best[i] + self._unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, self.unk_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, idx = back[pos]
            # fuse_unk: sentencepiece (and HF T5) emit ONE <unk> for a run
            # of unknown characters, not one per character
            if not (idx == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(idx)
            pos = start
        return ids[::-1]

    def __call__(self, texts: str | list[str],
                 max_length: int = 256) -> np.ndarray:
        """HF T5 ``padding='max_length', truncation=True`` layout:
        ``[t0..tk, eos, pad...]``; the empty string -> ``[eos, pad...]``
        (the diffusers empty-negative-prompt conditioning)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: max_length - 1]
            row = [*ids, self.eos_id]
            out[i, : len(row)] = row
        return out
