r"""CLIP byte-level BPE tokenizer — pure Python, HF-``CLIPTokenizer``
semantics.

This is the tokenizer behind both SD3 CLIP text encoders
(``src/SD3NaturalInference.py:184`` tokenizes via diffusers ->
``transformers.CLIPTokenizer``).  Pipeline per token of the pretokenizer
(:func:`pretokenize`): UTF-8 bytes -> printable-unicode alias chars (GPT-2
``bytes_to_unicode`` table) -> BPE over the merge ranks with the CLIP
``</w>`` end-of-word marker -> vocab ids.

A copy of ``naturaldiffusion_tpu/text/clip_bpe.py`` whose pretokenizer
does without the ``regex`` package: the ``\p{L}`` and ``\p{N}`` classes of
CLIP's pattern are ``unicodedata`` categories, and the literal alternatives
(the two specials and the contractions) a standard ``re`` pattern with
``IGNORECASE``.  ``tests/test_torch_text.py`` holds it to the ``regex``
pattern at every code point and on random strings.

Text cleaning follows HF's no-ftfy path (BERT ``BasicTokenizer`` with
``strip_accents=False, do_split_on_punc=False``): control-char removal,
CJK spacing, NFC, whitespace collapse, lowercase.  (With ftfy installed HF
additionally repairs mojibake first; for well-formed prompts the two paths
agree.  The port does not use ftfy.)

Asset files are the standard pair: ``vocab.json`` (token -> id) and
``merges.txt`` (one ranked merge per line, ``#version`` header).
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache

import numpy as np

# The CLIP pretokenizer (openai/CLIP simple_tokenizer; HF CLIPTokenizer.pat)
# is the regex-package pattern
#     <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|
#     [\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+        (IGNORECASE)
# scanned by findall.  Its literal alternatives, tried first, are this
# standard pattern (whose case-insensitive letters match the same
# characters: "s" also matches U+017F); the classes are written out below.
_LITERALS = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
    re.IGNORECASE)


def _is_letter(ch: str) -> bool:
    r"""``[\p{L}]``: general category L*."""
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    r"""``[\p{N}]``: general category N*."""
    return unicodedata.category(ch)[0] == "N"


def _is_other(ch: str) -> bool:
    r"""``[^\s\p{L}\p{N}]`` under IGNORECASE: not whitespace, and no case
    variant of the character a letter or a number.  So U+0345 (a
    combining mark whose uppercase is a Greek letter) is in none of the
    three classes, and the scan skips it as it skips spaces."""
    if ch.isspace():
        return False
    return not any(len(v) == 1 and unicodedata.category(v)[0] in "LN"
                   for v in (ch, ch.upper(), ch.lower(), ch.casefold()))


def pretokenize(text: str) -> list[str]:
    """CLIP's pattern's ``findall`` over ``text``: at each position the
    first alternative that matches (a special, a contraction, a run of
    letters, one number, a run of others), else the character is
    skipped.  The classes follow Python's ``unicodedata``; the cleaned
    text :func:`basic_clean` returns holds no unassigned code point."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        m = _LITERALS.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        ch = text[i]
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_other(ch):
            while j < n and _is_other(text[j]):
                j += 1
        elif not _is_number(ch):
            i = j                       # whitespace or U+0345: no token
            continue
        out.append(text[i:j])
        i = j
    return out


@lru_cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """BERT BasicTokenizer(strip_accents=False, do_split_on_punc=False):
    the exact cleaning HF CLIPTokenizer applies when ftfy is absent."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    text = "".join(out)
    out = []
    for ch in text:
        if _is_cjk(ord(ch)):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPBPETokenizer:
    """``tok = CLIPBPETokenizer.from_files(vocab_json, merges_txt)``;
    ``tok(["a photo of a cat"])`` -> ``[B, 77]`` int32 ids
    (bos + tokens + eos, eos-padded — the SD3 conditioning layout)."""

    def __init__(self, encoder: dict[str, int],
                 merges: list[tuple[str, str]],
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(encoder)
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token = bos_token, eos_token
        self.bos_id = self.encoder[bos_token]
        self.eos_id = self.encoder[eos_token]
        self.unk_id = self.eos_id          # HF: unk_token == eos_token
        self.pad_id = self.eos_id          # HF: pad_token == eos_token
        self._cache: dict[str, str] = {bos_token: bos_token,
                                       eos_token: eos_token}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   **kw) -> "CLIPBPETokenizer":
        with open(vocab_json, encoding="utf-8") as fh:
            encoder = json.load(fh)
        with open(merges_txt, encoding="utf-8") as fh:
            # line 0 is the '#version' header (HF skips it by position)
            lines = fh.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(ln.split()) for ln in lines]
        return cls(encoder, merges, **kw)

    # -- BPE ---------------------------------------------------------------

    def bpe(self, token: str) -> str:
        """Merge loop over (char..., last+'</w>'); identical to HF's."""
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    # -- encoding ----------------------------------------------------------

    def tokenize(self, text: str) -> list[str]:
        bpe_tokens: list[str] = []
        for tok in pretokenize(basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            bpe_tokens.extend(self.bpe(tok).split(" "))
        return bpe_tokens

    def encode(self, text: str,
               extra_specials: tuple[str, ...] = ()) -> list[int]:
        """Token ids WITHOUT bos/eos framing.

        Matches HF's added-token trie (``PreTrainedTokenizer.tokenize``):
        special-token strings — bos, eos, and any ``extra_specials`` such
        as a ``"!"`` pad token — are split out of the RAW text first
        (exact match, before cleaning), emit their own id, and the
        surrounding segments are cleaned+BPE'd independently, so a word
        abutting a special gets its ``</w>`` at the cut (fuzz-pinned vs
        transformers in ``tests/test_text_fuzz.py``)."""
        specials = {self.bos_token: self.bos_id, self.eos_token: self.eos_id}
        for s in extra_specials:
            specials[s] = self.encoder[s]
        pat = "|".join(re.escape(s)
                       for s in sorted(specials, key=len, reverse=True))
        ids: list[int] = []
        for part in re.split(f"({pat})", text):
            if part in specials:
                ids.append(specials[part])
            elif part:
                ids.extend(self.encoder.get(t, self.unk_id)
                           for t in self.tokenize(part))
        return ids

    def __call__(self, texts: str | list[str],
                 context_length: int = 77,
                 pad_token: str | None = None) -> np.ndarray:
        """HF ``padding='max_length', truncation=True`` layout:
        ``[bos, t0..tk, eos, pad...]``.  Default pad is eos (CLIP-L /
        ``CLIPTokenizer``); SD3's CLIP-G tokenizer_2 pads with ``"!"``
        (id 0) instead — pass ``pad_token="!"`` for that layout."""
        if isinstance(texts, str):
            texts = [texts]
        pad_id = self.encoder[pad_token] if pad_token is not None \
            else self.pad_id
        extra = (pad_token,) if pad_token is not None else ()
        out = np.full((len(texts), context_length), pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text, extra_specials=extra)[: context_length - 2]
            row = [self.bos_id, *ids, self.eos_id]
            out[i, : len(row)] = row
        return out
