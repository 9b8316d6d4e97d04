"""SD3 prompt -> token-ids assembly (the tokenization stage of
``pipe.encode_prompt``, ``src/SD3NaturalInference.py:184``).

Produces exactly the ids dict the rest of the stack consumes
(``apps/sd3_ni.py --ids`` npz layout / ``SD3Pipeline.encode_prompt``):
``ids_l``/``ids_g`` are 77-token CLIP rows, ``ids_t5`` is the T5 row, and
the ``neg_*`` trio conditions the CFG null branch.  Copy of
``naturaldiffusion_tpu/text/sd3.py``.
"""

from __future__ import annotations

import numpy as np


def sd3_tokenize_ids(prompt: str | list[str],
                     negative_prompt: str | list[str] = "",
                     *, clip_l, clip_g=None, t5=None,
                     clip_length: int = 77,
                     t5_length: int = 256) -> dict[str, np.ndarray]:
    """Tokenize the positive/negative prompt pair with the two CLIP BPE
    tokenizers (usually one shared vocab) and optionally T5 sentencepiece.

    ``clip_g`` defaults to ``clip_l`` (SD3's two CLIP tokenizers share the
    vocab); ``t5=None`` skips the T5 ids (matching the pooled-only setups).
    """
    if isinstance(prompt, str):
        prompt = [prompt]
    if isinstance(negative_prompt, str):
        negative_prompt = [negative_prompt] * len(prompt)
    clip_g = clip_g or clip_l

    # diffusers SD3: tokenizer (CLIP-L) pads with eos, tokenizer_2 (CLIP-G)
    # pads with "!" (id 0); both CLIP-G encoders run unmasked, so the pad id
    # is numerically load-bearing.  Synthetic test vocabs without "!" fall
    # back to eos-padding (the two layouts coincide only there).
    g_pad = "!" if "!" in clip_g.encoder else None
    ids = {
        "ids_l": clip_l(prompt, context_length=clip_length),
        "ids_g": clip_g(prompt, context_length=clip_length,
                        pad_token=g_pad),
        "neg_ids_l": clip_l(negative_prompt, context_length=clip_length),
        "neg_ids_g": clip_g(negative_prompt, context_length=clip_length,
                            pad_token=g_pad),
    }
    if t5 is not None:
        ids["ids_t5"] = t5(prompt, max_length=t5_length)
        ids["neg_ids_t5"] = t5(negative_prompt, max_length=t5_length)
    return ids
