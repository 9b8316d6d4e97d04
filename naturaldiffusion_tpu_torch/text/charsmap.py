"""SentencePiece ``precompiled_charsmap`` — parser, matcher, and builder.

Copy of ``naturaldiffusion_tpu/text/charsmap.py`` (numpy only), kept here so
the port never imports the JAX package.

The ``spiece.model`` NormalizerSpec carries a *compiled* normalization map
(proto field 2): the nmt_nfkc rewrite rules compiled into a darts-clone
double-array trie plus a pool of NUL-terminated replacement strings.  The
reference's prompt path reaches it through ``transformers.T5Tokenizer``
(``src/SD3NaturalInference.py:184`` -> sentencepiece); ``text/spm.py``
previously approximated it with ``unicodedata`` NFKC.  This module
interprets the real blob, so normalization is byte-exact even where
nmt_nfkc diverges from NFKC (control-char stripping, whitespace folding,
and the NMT-specific rewrites).

Blob layout (sentencepiece ``normalizer.cc``):

    [0:4]    uint32 LE -- byte size N of the trie image
    [4:4+N]  uint32[]  -- darts-clone double-array units
    [4+N:]   bytes     -- NUL-terminated replacement pool; a trie hit's
                          value is a byte offset into this pool

Double-array unit decoding (darts-clone ``DoubleArrayUnit``):

    has_leaf = (u >> 8) & 1
    value    = u & 0x7fffffff            (leaf units carry bit 31)
    label    = u & (0x80000000 | 0xff)
    offset   = (u >> 10) << ((u & 0x200) >> 6)

``build_charsmap`` emits the same format (the tests use it to synthesize
charsmaps with known rules; it also lets users compile custom normalizer
maps).  It packs nodes first-fit — valid, just not as dense as
darts-clone's builder.
"""

from __future__ import annotations

import struct

import numpy as np

_LEAF = -1          # builder-trie sentinel key for "key terminates here"
_MAX_DIRECT_OFFSET = (1 << 21) - 1   # offsets above need the <<8 mode


def _utf8_span(data: bytes, i: int) -> int:
    """Length of the UTF-8 sequence starting at ``i`` (>=1, clamped)."""
    b = data[i]
    if b < 0x80:
        n = 1
    elif b >= 0xF0:
        n = 4
    elif b >= 0xE0:
        n = 3
    elif b >= 0xC0:
        n = 2
    else:               # stray continuation byte: consume it alone
        n = 1
    return min(n, len(data) - i)


class PrecompiledCharsmap:
    """Longest-prefix rewrite over a darts-clone double-array trie."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (tsize,) = struct.unpack("<I", blob[:4])
        if tsize % 4 or 4 + tsize > len(blob):
            raise ValueError(
                f"corrupt charsmap: trie size {tsize} of {len(blob)} bytes")
        self._units = np.frombuffer(blob, dtype="<u4",
                                    count=tsize // 4, offset=4)
        self._pool = blob[4 + tsize:]

    # -- trie ---------------------------------------------------------------

    @staticmethod
    def _offset(u: int) -> int:
        return (u >> 10) << ((u & 0x200) >> 6)

    def longest_match(self, data: bytes, pos: int) -> tuple[int, int]:
        """Longest trie match of ``data[pos:]`` -> ``(pool_offset, length)``;
        ``length == 0`` means no rule applies at ``pos``."""
        units = self._units
        n_units = len(units)
        node = 0
        u = int(units[0])
        node ^= self._offset(u)
        best_val, best_len = 0, 0
        for i in range(pos, len(data)):
            c = data[i]
            node ^= c
            if node >= n_units:
                break
            u = int(units[node])
            if (u & 0x800000FF) != c:           # label mismatch: dead end
                break
            node ^= self._offset(u)
            if (u >> 8) & 1:                    # node has a value leaf
                if node < n_units:
                    best_val = int(units[node]) & 0x7FFFFFFF
                    best_len = i - pos + 1
        return best_val, best_len

    def replacement(self, pool_offset: int) -> bytes:
        end = self._pool.find(b"\0", pool_offset)
        return self._pool[pool_offset:end if end >= 0 else len(self._pool)]

    # -- normalization ------------------------------------------------------

    def normalize_bytes(self, data: bytes) -> bytes:
        out = []
        i, n = 0, len(data)
        while i < n:
            val, ln = self.longest_match(data, i)
            if ln:
                out.append(self.replacement(val))
                i += ln
            else:                       # no rule: copy one UTF-8 char as-is
                step = _utf8_span(data, i)
                out.append(data[i:i + step])
                i += step
        return b"".join(out)

    def normalize(self, text: str) -> str:
        return self.normalize_bytes(text.encode("utf-8")).decode(
            "utf-8", errors="replace")


# ---------------------------------------------------------------------------
# builder (tests / custom normalizers)
# ---------------------------------------------------------------------------


def build_charsmap(rules: dict[bytes, bytes]) -> bytes:
    """Compile ``{key_bytes: replacement_bytes}`` into a charsmap blob that
    :class:`PrecompiledCharsmap` (and sentencepiece itself) can read."""
    pool = bytearray()
    trie: dict = {}
    for key in sorted(rules):
        if not key:
            raise ValueError("empty charsmap key")
        node = trie
        for b in key:
            node = node.setdefault(b, {})
        node[_LEAF] = len(pool)
        pool += rules[key] + b"\0"

    units: list[int] = [0]          # position 0 = root
    used = {0}
    # a base (pos ^ off) may belong to at most ONE node: otherwise a
    # lookup from a base-sharing node of a label only the other node has
    # lands on the other node's child with a matching label byte — a
    # false-positive transition the per-unit label check cannot catch
    used_bases = set()

    def place(pos: int, node: dict) -> None:
        labels = sorted(k for k in node if k != _LEAF)
        slots = ([0] if _LEAF in node else []) + labels
        off = 0
        if slots:
            off = 1
            while (pos ^ off) in used_bases or \
                    any((pos ^ off ^ c) in used for c in slots):
                off += 1
                if off > _MAX_DIRECT_OFFSET:
                    raise ValueError("charsmap trie too large for builder")
            used_bases.add(pos ^ off)
            hi = max(pos ^ off ^ c for c in slots)
            while hi >= len(units):
                units.append(0)
            for c in slots:
                used.add(pos ^ off ^ c)
        units[pos] |= off << 10
        if _LEAF in node:
            units[pos] |= 1 << 8                      # has_leaf
            units[pos ^ off] = 0x80000000 | node[_LEAF]
        for c in labels:
            child = pos ^ off ^ c
            units[child] = c                          # label byte
            place(child, node[c])

    place(0, trie)
    trie_img = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie_img)) + trie_img + bytes(pool)
