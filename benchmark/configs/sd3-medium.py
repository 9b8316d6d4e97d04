"""SD3-medium text to image: the system under test and its check.

The system is the port's ``pipeline.SD3Pipeline`` over its five models at
their published widths (every weight random from the seed, bfloat16, made
on the card): ``encode_prompt`` for the prompt and for the empty negative
prompt (CLIP-L, CLIP-G, T5-XXL), then ``__call__`` (28 NI steps of the
shifted flow-Euler matrix, CFG over the MMDiT with kernel K9 for the joint
attention, K1 for each step's sums) and the VAE's ``decode``: what
``__call__(decode=True)`` runs, as its two calls, so that the latents can
be checked apart from the decode.  One request is one prompt and
``batch`` images; its token ids and latent noise come from the seed and
the request's index.  The conditioning is encoded once a prompt and
repeated over the batch, as diffusers does for ``num_images_per_prompt``.

The check runs the sampled requests through the plain float32 references
(``benchmark/reference``, TF32 off), one model at a time so that they fit:
the encoders on the same ids, the MMDiT under the Euler matrix made anew in
NumPy with the NI sums in float64 from the reference's own conditioning,
and the VAE on the reference's own latents.  It compares the conditioning,
the latents and the images by relative L2.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import torch

from benchmark.harness.inputs import rel_l2, request_generator
from benchmark.harness.weights import fill_, leaf_rule, model_seed
from benchmark.reference import samplers
from benchmark.reference.mmdit import MMDiT as RefMMDiT
from benchmark.reference.mmdit import cfg_velocity
from benchmark.reference.precision import F32, Precision, no_tf32
from benchmark.reference.text import T5, CLIPText, encode_prompt
from benchmark.reference.vae import VAE

WARM = 2 ** 20
PARTS = ("mmdit", "clip_l", "clip_g", "t5", "vae")      # model_seed order
CLIP_BOS, CLIP_EOS = 49406, 49407


def prompt_ids(spec, g, device):
    """One random prompt's ``(ids_l, ids_g, ids_t5)``, batch 1."""
    n = spec["clip_tokens"]
    ids = torch.randint(1, CLIP_BOS, (1, n), generator=g, device=device)
    ids[:, 0], ids[:, -1] = CLIP_BOS, CLIP_EOS
    t5 = torch.randint(2, 32100, (1, spec["t5_tokens"]), generator=g,
                       device=device)
    return ids, ids.clone(), t5


def empty_ids(spec, device):
    """The empty negative prompt as the published tokenizers give it."""
    n = spec["clip_tokens"]
    ids_l = torch.full((1, n), CLIP_EOS, device=device)
    ids_l[0, 0] = CLIP_BOS
    ids_g = torch.zeros((1, n), dtype=torch.long, device=device)
    ids_g[0, :2] = torch.tensor([CLIP_BOS, CLIP_EOS])
    t5 = torch.zeros((1, spec["t5_tokens"]), dtype=torch.long, device=device)
    t5[0, 0] = 1
    return ids_l, ids_g, t5


def request_inputs(spec, traffic, seed, i, device):
    """``(prompt ids, latent noise [batch, L, L, C])`` of request ``i``."""
    g = request_generator(seed, i, device)
    ids = prompt_ids(spec, g, device)
    lat = traffic["latent"]
    noise = torch.randn((traffic["batch"], lat, lat,
                         spec["mmdit"]["in_channels"]), generator=g,
                        device=device)
    return ids, noise


def rule(spec, part):
    """The weights' rule of ``part``.  T5 computes its scores without
    ``1/sqrt(d_kv)``; its own init (Mesh TensorFlow's, HF
    ``T5PreTrainedModel._init_weights``) folds that factor into ``q``'s
    standard deviation, and so does this rule.  With ``q`` at fan-in
    alone every score's spread is 8x wider, the softmax all but one-hot,
    and bfloat16's rounding flips its choices: the encoder then differs
    from float32 by 0.3 to 0.7 relative L2 (measured)."""
    if part != "t5":
        return leaf_rule
    root = math.sqrt(spec["t5"]["d_kv"])

    def t5(name, shape):
        std, mean = leaf_rule(name, shape)
        return (std / root if name.endswith(".q.kernel") else std), mean
    return t5


@contextlib.contextmanager
def default_dtype(dt):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dt)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SD3:
    def __init__(self, spec, traffic, seed, device):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.device = torch.device(device)
        self.pipe = None

    def setup(self, wait_build):
        from naturaldiffusion_tpu_torch.models import text_encoders as te
        from naturaldiffusion_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
        from naturaldiffusion_tpu_torch.models.vae import (AutoencoderKL,
                                                           VAEConfig)
        from naturaldiffusion_tpu_torch.pipeline import SD3Pipeline
        s, dev, bf = self.spec, self.device, torch.bfloat16
        t0 = time.perf_counter()
        vcfg = dict(s["vae"], ch_mult=tuple(s["vae"]["ch_mult"]))
        # the encoders and the VAE have no shapes-only form: they are made
        # on the card at their own init, in bfloat16, then filled
        with default_dtype(bf):
            models = {
                "t5": te.T5Encoder(te.T5Config(**s["t5"]), device=dev),
                "clip_l": te.CLIPTextEncoder(te.CLIPTextConfig(**s["clip_l"]),
                                             device=dev),
                "clip_g": te.CLIPTextEncoder(te.CLIPTextConfig(**s["clip_g"]),
                                             device=dev),
                "vae": AutoencoderKL(VAEConfig(**vcfg), device=dev)}
        models["mmdit"] = MMDiT(MMDiTConfig(**s["mmdit"]), device="meta")
        for k, m in models.items():
            fill_(m, model_seed(self.seed, PARTS.index(k)), bf, dev,
                  rule=rule(s, k))
            m.eval()
        self.pipe = SD3Pipeline(cfg_scale=s["cfg_scale"], shift=s["shift"],
                                **models)
        self.neg = empty_ids(s, dev)
        _sync(dev)
        t1 = time.perf_counter()
        wait_build()
        t2 = time.perf_counter()
        self.run(WARM, {})
        print(f"[bench] set-up: models {t1 - t0:.2f} s, build wait "
              f"{t2 - t1:.2f} s, warm request "
              f"{time.perf_counter() - t2:.2f} s", file=sys.stderr, flush=True)

    @torch.no_grad()
    def run(self, i, spans):
        ids, noise = request_inputs(self.spec, self.traffic, self.seed, i,
                                    self.device)
        pipe, b = self.pipe, noise.shape[0]
        t0 = time.perf_counter()
        with torch.profiler.record_function("encode_prompt"):
            ctx, pooled = pipe.encode_prompt(*ids)
            nctx, npooled = pipe.encode_prompt(*self.neg)
            _sync(self.device)
        t1 = time.perf_counter()
        cond = dict(context=ctx.expand(b, -1, -1),
                    pooled=pooled.expand(b, -1),
                    neg_context=nctx.expand(b, -1, -1),
                    neg_pooled=npooled.expand(b, -1))
        with torch.profiler.record_function("sample"):
            lat = pipe(noises=noise, num_steps=self.spec["steps"],
                       decode=False, **cond)
            _sync(self.device)
        t2 = time.perf_counter()
        with torch.profiler.record_function("decode"):
            img = pipe.vae.decode(pipe.vae.unscale_latents(lat))
            _sync(self.device)
        t3 = time.perf_counter()
        for k, v in (("encode", t1 - t0), ("sample", t2 - t1),
                     ("decode", t3 - t2)):
            spans.setdefault(k, []).append(v)
        return [{"images": img, "latents": lat,
                 "cond": (ctx, pooled, nctx, npooled)}]

    def images(self, answers):
        return sum(a["images"].shape[0] for a in answers)

    def free(self):
        self.pipe = None


class Checker:
    """The references, made one at a time on the card from the same seeds,
    in float32, and dropped after use."""

    def __init__(self, spec, traffic, seed, device):
        self.spec, self.traffic, self.seed = spec, traffic, seed
        self.device = torch.device(device)

    def _model(self, part):
        cls = {"mmdit": RefMMDiT, "clip_l": CLIPText, "clip_g": CLIPText,
               "t5": T5, "vae": VAE}[part]
        with torch.device("meta"):
            m = cls(**self.spec[part])
        return fill_(m, model_seed(self.seed, PARTS.index(part)),
                     torch.bfloat16, self.device, cast=torch.float32,
                     rule=rule(self.spec, part))

    @torch.no_grad()
    def reference_answers(self, keys, p: Precision = F32):
        """The reference's conditioning, latents and images of requests
        ``keys`` (the ``(i, j)`` of :meth:`check`)."""
        s = self.spec
        ins = {k: request_inputs(s, self.traffic, self.seed, k[0],
                                 self.device) for k in keys}
        neg = empty_ids(s, self.device)
        outs = {k: {} for k in keys}
        t0 = time.perf_counter()
        with no_tf32():
            enc = {}
            for part in ("t5", "clip_l", "clip_g"):
                m = self._model(part)
                for k in keys:
                    ids = ins[k][0]
                    idx = {"clip_l": 0, "clip_g": 1, "t5": 2}[part]
                    enc[(k, part)] = (m(ids[idx], p), m(neg[idx], p))
                del m
            for k in keys:
                cond = []
                for side in (0, 1):
                    pl, ql = enc[(k, "clip_l")][side]
                    pg, qg = enc[(k, "clip_g")][side]
                    cond += encode_prompt(pl, ql, pg, qg,
                                          enc[(k, "t5")][side],
                                          s["mmdit"]["joint_attention_dim"])
                outs[k]["cond"] = tuple(cond)
            del enc
            t1 = time.perf_counter()
            mm = self._model("mmdit")
            x0m, epsm, node = samplers.sd3_euler_matrix(s["steps"],
                                                        s["shift"])
            for k in keys:
                ctx, pooled, nctx, npooled = outs[k]["cond"]
                b = ins[k][1].shape[0]
                ctx2 = torch.cat([ctx.expand(b, -1, -1),
                                  nctx.expand(b, -1, -1)])
                pool2 = torch.cat([pooled.expand(b, -1),
                                   npooled.expand(b, -1)])
                outs[k]["latents"] = samplers.natural_inference(
                    lambda z, t: cfg_velocity(mm, z, t, ctx2, pool2,
                                              s["cfg_scale"], p),
                    x0m, epsm, node, ins[k][1], prediction="v_flow")
            del mm
            t2 = time.perf_counter()
            vae = self._model("vae")
            for k in keys:
                outs[k]["images"] = torch.cat([
                    vae.decode(z[None].float(), p)
                    for z in outs[k]["latents"]])
            _sync(self.device)
        print(f"[bench] reference ({p.name}): encoders {t1 - t0:.1f} s, "
              f"mmdit {t2 - t1:.1f} s, vae {time.perf_counter() - t2:.1f} s",
              file=sys.stderr, flush=True)
        return outs

    def check(self, answers, keys):
        want = self.reference_answers(keys)
        lim = self.traffic["limits"]
        cond = max(rel_l2(torch.cat([a.reshape(-1) for a in
                                     answers[k]["cond"]]),
                          torch.cat([a.reshape(-1) for a in
                                     want[k]["cond"]])) for k in keys)
        lat = max(rel_l2(answers[k]["latents"], want[k]["latents"])
                  for k in keys)
        img = max(rel_l2(answers[k]["images"], want[k]["images"])
                  for k in keys)
        return [("cond_rel_l2", cond, lim["cond_rel_l2"]),
                ("latent_rel_l2", lat, lim["latent_rel_l2"]),
                ("image_rel_l2", img, lim["image_rel_l2"])]


def make(spec, traffic, seed, device):
    return SD3(spec, traffic, seed, device)


def make_checker(spec, traffic, seed, device):
    return Checker(spec, traffic, seed, device)
