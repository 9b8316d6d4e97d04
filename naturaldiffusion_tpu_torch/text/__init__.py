"""Prompt -> token-ids tokenization (the reference's raw-text entry).

Copy of ``naturaldiffusion_tpu/text/`` (pure Python and numpy), kept here so
the port never imports the JAX package; the CLIP pretokenizer is written
with ``unicodedata`` and the standard ``re`` instead of ``regex``.

The reference goes raw text to image through diffusers'
``pipe.encode_prompt`` (``src/SD3NaturalInference.py:184``), which tokenizes
with CLIP byte-level BPE (x2) and T5 SentencePiece internally.  These are
those tokenizer *engines*, dependency-free: the vocab assets (vocab.json /
merges.txt / spiece.model) are external blobs, the algorithms are here and
unit-tested on synthetic fixtures.
"""

from .clip_bpe import CLIPBPETokenizer, bytes_to_unicode
from .spm import SentencePieceUnigram
from .sd3 import sd3_tokenize_ids

__all__ = ["CLIPBPETokenizer", "bytes_to_unicode", "SentencePieceUnigram",
           "sd3_tokenize_ids"]
