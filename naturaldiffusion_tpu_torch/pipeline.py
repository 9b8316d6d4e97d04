"""SD3Pipeline, the front door of SD3 Natural Inference (port of
``naturaldiffusion_tpu/pipeline.py``).

The reference drives everything through diffusers'
``StableDiffusion3Pipeline`` (``src/SD3NaturalInference.py:175-243``):
encode_prompt -> 28 transformer steps -> VAE decode.  This is that surface
on the port: the three text encoders, the MMDiT, the NI engine (one loop,
kernel K1 for each step's weighted sum) and the VAE, each an ``nn.Module``
that holds its weights (converted from HF checkpoints, or random).

    pipe = SD3Pipeline.from_parts(mmdit=..., vae=..., clip_l=..., ...)
    images = pipe(prompt="a photo of a cat", noises=z, num_steps=28,
                  weights=sharp_csv_matrix)

Conditioning enters at any stage: raw text (the port's CLIP BPE and T5
sentencepiece tokenizers, given their vocabularies), token ids
(:meth:`encode_prompt`), or embeddings.  The JAX package jits one run per
step count; here the run is eager, the same steps in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .coeffs.sd3 import sd3_euler_weights, sd3_weight_matrix
from .engine import NISchedule, natural_inference


@dataclasses.dataclass
class SD3Pipeline:
    """The assembled SD3 stack.  Every part but the transformer is
    optional: without text encoders pass embeddings; without a VAE the
    latents come back."""

    mmdit: Any
    vae: Any = None
    clip_l: Any = None
    clip_g: Any = None
    t5: Any = None
    tokenizer_clip: Any = None     # text.CLIPBPETokenizer (shared L/G vocab)
    tokenizer_t5: Any = None       # text.SentencePieceUnigram
    cfg_scale: float = 7.0
    shift: float = 3.0

    @classmethod
    def from_parts(cls, **kw) -> "SD3Pipeline":
        return cls(**kw)

    # -- conditioning -------------------------------------------------------

    def tokenize(self, prompt, negative_prompt="", t5_length: int = 256):
        """Raw text -> the ids dict (``text.sd3_tokenize_ids``), with
        ``tokenizer_clip`` and, when given, ``tokenizer_t5``.  The CLIP row
        length follows the encoder's position table (77 for SD3)."""
        from .text import sd3_tokenize_ids
        if self.tokenizer_clip is None:
            raise ValueError("pipeline has no tokenizer; pass ids or embeds")
        clip_length = self.clip_l.config.max_positions if self.clip_l \
            else 77
        return sd3_tokenize_ids(prompt, negative_prompt,
                                clip_l=self.tokenizer_clip,
                                t5=self.tokenizer_t5,
                                clip_length=clip_length,
                                t5_length=t5_length)

    @torch.no_grad()
    def encode_prompt(self, ids_l, ids_g, ids_t5=None):
        """Token ids -> ``(prompt_embeds, pooled)`` through the encoders
        (``models.text_encoders.sd3_encode_prompt``).  Numpy ids are moved
        to the encoders' device."""
        from .models.text_encoders import sd3_encode_prompt
        if self.clip_l is None or self.clip_g is None:
            raise ValueError("pipeline has no text encoders; pass embeds")
        dev = self.clip_l.token_embedding.embedding.device

        def ids(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a) if not torch.is_tensor(a) else a,
                dtype=torch.long, device=dev)

        return sd3_encode_prompt(
            self.clip_l, ids(ids_l), self.clip_g, ids(ids_g),
            self.t5, ids(ids_t5),
            joint_dim=self.mmdit.config.joint_attention_dim)

    # -- sampling -----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, *, noises, context=None, pooled=None,
                 neg_context=None, neg_pooled=None,
                 prompt=None, negative_prompt="",
                 num_steps: int = 28, weights: np.ndarray | None = None,
                 decode: bool = True):
        """Run Natural Inference from ``noises`` ``[B, H, W, C]``;
        ``weights`` defaults to the vanilla-Euler matrix (exact Euler
        sampling); pass the learned or sharp CSV matrices for sharpness
        control.  Conditioning: the four embedding tensors, or ``prompt=``
        and ``negative_prompt=`` raw text.  The transformer runs in its
        weights' type, the NI sums in float32.  Returns decoded images
        (VAE present and ``decode``) or the float32 latents."""
        from .models.mmdit import mmdit_cfg_fwd_mods
        if prompt is not None:
            ids = self.tokenize(prompt, negative_prompt)
            context, pooled = self.encode_prompt(
                ids["ids_l"], ids["ids_g"], ids.get("ids_t5"))
            neg_context, neg_pooled = self.encode_prompt(
                ids["neg_ids_l"], ids["neg_ids_g"], ids.get("neg_ids_t5"))
        if context is None or pooled is None \
                or neg_context is None or neg_pooled is None:
            raise ValueError("pass prompt= or the four embedding tensors")
        if weights is None:
            weights = sd3_euler_weights(num_steps, shift=self.shift)
        sched = NISchedule.from_matrix(
            sd3_weight_matrix(weights, num_steps, shift=self.shift),
            device=noises.device)
        # the schedule is static: every timestep embedding and adaLN
        # modulation is computed before the loop and rides step_inputs
        fwd, step_inputs = mmdit_cfg_fwd_mods(
            self.mmdit, ctx2=torch.cat([context, neg_context]),
            pool2=torch.cat([pooled, neg_pooled]),
            t_all=sched.node[:num_steps, 0], cfg_scale=self.cfg_scale)
        latents = natural_inference(fwd, sched, noises,
                                    prediction_type="v_flow",
                                    model_dtype=self.mmdit.dtype,
                                    step_inputs=step_inputs)
        if decode and self.vae is not None:
            return self.vae.decode(self.vae.unscale_latents(latents))
        return latents
