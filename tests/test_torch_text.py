"""The port's tokenizers (``naturaldiffusion_tpu_torch/text``) against the
JAX package's on the synthetic fixtures of ``tests/test_text.py`` and the
trained vocabulary of ``tests/test_text_fuzz.py``: every id equal.  The
port's CLIP pretokenizer does without the ``regex`` package, so its
classes are held to ``regex``'s ``[\\p{L}]``, ``[\\p{N}]`` and
``[^\\s\\p{L}\\p{N}]`` (IGNORECASE) at every code point the cleaning keeps,
and the whole tokenizer to JAX's on random Unicode strings (``hypothesis``:
letters, digits, marks, CJK, punctuation, spaces and the special
tokens)."""

import json
import random
import unicodedata

import numpy as np
import pytest
import regex
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch_port_util  # noqa: F401  (torch's CPU math bound first)
from naturaldiffusion_tpu import text as jtext
from naturaldiffusion_tpu.text import charsmap as jcharsmap
from naturaldiffusion_tpu.text import clip_bpe as jclip
from naturaldiffusion_tpu.text import spm as jspm
from naturaldiffusion_tpu_torch import text as ttext
from naturaldiffusion_tpu_torch.text import charsmap as tcharsmap
from naturaldiffusion_tpu_torch.text import clip_bpe as tclip
from naturaldiffusion_tpu_torch.text import spm as tspm
from test_text import _clip_fixture, _spm_fixture
from test_text_fuzz import _CORPUS, _rand_text, _train_bpe

torch.set_num_threads(2)

SPECIALS = ["<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve",
            "'m", "'ll", "'d", "'S", "'ſ", "'LL", "<|ſtartoftext|>", "!"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fuzz file's real-shaped vocabulary: byte-level base, ``</w>``
    forms and merges trained on a corpus."""
    tmp = tmp_path_factory.mktemp("torch_clip")
    b2u = jtext.bytes_to_unicode()
    base = [b2u[b] for b in range(256)]
    merges = _train_bpe(_CORPUS)
    tokens = base + [c + "</w>" for c in base] + ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    vpath, mpath = tmp / "vocab.json", tmp / "merges.txt"
    vpath.write_text(json.dumps(vocab), encoding="utf-8")
    mpath.write_text("#version: 0.2\n"
                     + "\n".join(" ".join(m) for m in merges) + "\n",
                     encoding="utf-8")
    return (jtext.CLIPBPETokenizer.from_files(str(vpath), str(mpath)),
            ttext.CLIPBPETokenizer.from_files(str(vpath), str(mpath)))


def test_bytes_to_unicode_and_basic_clean_equal_jax():
    assert ttext.bytes_to_unicode() == jtext.bytes_to_unicode()
    rng = random.Random(1)
    for _ in range(300):
        s = _rand_text(rng)
        assert tclip.basic_clean(s) == jclip.basic_clean(s)


def test_classes_equal_regex_at_every_code_point():
    """Each character the cleaning keeps (every category but C*) is a
    letter, a number or an "other" for the port exactly when ``regex``'s
    class under IGNORECASE matches it; U+0345 is in none (its uppercase is
    a letter, so the negated class excludes it)."""
    cls = {"L": regex.compile(r"[\p{L}]", regex.IGNORECASE),
           "N": regex.compile(r"[\p{N}]", regex.IGNORECASE),
           "O": regex.compile(r"[^\s\p{L}\p{N}]", regex.IGNORECASE)}
    mine = {"L": tclip._is_letter, "N": tclip._is_number,
            "O": tclip._is_other}
    bad, kept = [], 0
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch)[0] == "C":
            continue
        kept += 1
        for k, pat in cls.items():
            if bool(pat.match(ch)) != mine[k](ch):
                bad.append((hex(cp), k))
    assert kept > 140_000 and not bad, bad[:20]
    assert not any(f("ͅ") for f in mine.values())


def test_clip_fixture_ids_equal_jax(tmp_path):
    """``tests/test_text.py``'s fixture vocabulary: tokens, ids and both pad
    layouts, truncation and batches."""
    vpath, mpath, vocab = _clip_fixture(tmp_path)
    j = jtext.CLIPBPETokenizer.from_files(vpath, mpath)
    t = ttext.CLIPBPETokenizer.from_files(vpath, mpath)
    texts = ["hello low", "Hello, LOWER world!", "  weird\tspacing  ",
             "café 中 lower", "hello's low't", "123 4,5!?", "",
             "hello " * 30, "<|startoftext|>low<|endoftext|>hello",
             "LOW'S 'LL ſ'ſ xͅy"]
    for text in texts:
        assert t.tokenize(text) == j.tokenize(text), text
        assert t.encode(text) == j.encode(text), text
    for kw in ({}, {"pad_token": "!"}):
        for n in (8, 10, 77):
            np.testing.assert_array_equal(t(texts, context_length=n, **kw),
                                          j(texts, context_length=n, **kw))
    assert t.encode("hello low") == [vocab["hello</w>"], vocab["low</w>"]]


@given(st.lists(st.one_of(st.text(min_size=1, max_size=4),
                          st.sampled_from(SPECIALS),
                          st.sampled_from(list("中文日本語한국어 \t\n")),
                          st.characters(categories=["Lu", "Ll", "Lm", "Lo",
                                                    "Mn", "Mc", "Nd", "Nl",
                                                    "No", "P", "S", "Zs"])),
                max_size=12).map("".join))
@settings(max_examples=400, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
def test_clip_tokenizer_fuzz_equals_jax(trained, text):
    """Random Unicode through both tokenizers on the trained vocabulary:
    the pretokenizer's pieces, and the ids in CLIP-L's and CLIP-G's
    layouts."""
    j, t = trained
    clean = jclip.basic_clean(text)
    assert tclip.pretokenize(clean) == jclip._PAT.findall(clean)
    assert t.encode(text) == j.encode(text)
    np.testing.assert_array_equal(t([text], context_length=24),
                                  j([text], context_length=24))
    np.testing.assert_array_equal(
        t([text], context_length=24, pad_token="!"),
        j([text], context_length=24, pad_token="!"))


def test_spm_fixture_ids_equal_jax(tmp_path):
    """``tests/test_text.py``'s T5 model, with and without the dummy
    prefix and with a charsmap: the parsed proto, the segmentations (unk
    fusing included) and the padded rows."""
    cs = jcharsmap.build_charsmap({"ａ".encode(): b"a", b"q": b"ab"})
    assert tcharsmap.build_charsmap({"ａ".encode(): b"a", b"q": b"ab"}) == cs
    texts = ["ab", "ab ab", "a", "abz", "ａｂ", "  ab   ab ", "", "abzzz",
             "abzaz", "q", "ａ", "ab " * 10, "c a　b"]
    for kw in ({}, {"dummy_prefix": False}, {"charsmap": cs}):
        path = _spm_fixture(tmp_path, **kw)
        with open(path, "rb") as fh:
            blob = fh.read()
        assert tspm.parse_model_proto(blob) == jspm.parse_model_proto(blob)
        j = jtext.SentencePieceUnigram.from_file(path)
        t = ttext.SentencePieceUnigram.from_file(path)
        for text in texts:
            assert t.normalize(text) == j.normalize(text), text
            assert t.encode(text) == j.encode(text), text
        for n in (4, 5, 16):
            np.testing.assert_array_equal(t(texts, max_length=n),
                                          j(texts, max_length=n))


def test_charsmap_equals_jax_on_random_rules():
    rng = random.Random(1234)
    for _ in range(20):
        rules = {}
        for _ in range(rng.randrange(1, 30)):
            k = bytes(rng.randrange(97, 103)
                      for _ in range(rng.randrange(1, 5)))
            rules[k] = bytes(rng.randrange(65, 91)
                             for _ in range(rng.randrange(0, 4)))
        blob = jcharsmap.build_charsmap(rules)
        assert tcharsmap.build_charsmap(rules) == blob
        jm = jcharsmap.PrecompiledCharsmap(blob)
        tm = tcharsmap.PrecompiledCharsmap(blob)
        for _ in range(20):
            data = bytes(rng.randrange(97, 105)
                         for _ in range(rng.randrange(0, 25)))
            assert tm.normalize_bytes(data) == jm.normalize_bytes(data)


def test_sd3_tokenize_ids_equal_jax(tmp_path):
    vpath, mpath, _ = _clip_fixture(tmp_path)
    spm = _spm_fixture(tmp_path)
    jc = jtext.CLIPBPETokenizer.from_files(vpath, mpath)
    tc = ttext.CLIPBPETokenizer.from_files(vpath, mpath)
    j5 = jtext.SentencePieceUnigram.from_file(spm)
    t5 = ttext.SentencePieceUnigram.from_file(spm)
    for prompt, neg in (("hello low", ""), (["lower", "Hello!"], "low")):
        for use_t5 in (True, False):
            want = jtext.sd3_tokenize_ids(prompt, neg, clip_l=jc,
                                          t5=j5 if use_t5 else None,
                                          t5_length=16)
            got = ttext.sd3_tokenize_ids(prompt, neg, clip_l=tc,
                                         t5=t5 if use_t5 else None,
                                         t5_length=16)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == np.int32
