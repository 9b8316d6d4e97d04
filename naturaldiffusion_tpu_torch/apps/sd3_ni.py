"""SD3 Natural Inference with sharpness control (port of
``naturaldiffusion_tpu/apps/sd3_ni.py``, ``src/SD3NaturalInference.py:
157-250`` rebuilt on the port's MMDiT).

The NI form re-projects every step from the weighted x0 history:

    model_input = sigma_k * noise + (1 - sigma_k) * weighted_x0

with ``weighted_x0 = sum_j w[k,j] x0_j / sum_j w[k,j]`` (row-sum
normalized, reference ``weighted_sum:157-168``); the "sharp" CSV
zero-clips old columns and boosts the final diagonal (paper §5.3).  That
update is affine, so it runs as one NI schedule
(``coeffs.sd3.sd3_weight_matrix``); :func:`sd3_natural_inference_host` is
the reference-shaped loop kept as its oracle.

Conditioning: ``--embeds embeds.npz`` (``prompt_embeds [B,T,4096]``,
``pooled [B,2048]`` and the ``negative_*`` pair), ``--ids ids.npz`` (token
ids through the port's CLIP-L, CLIP-G and T5-XXL, with ``--clip-l``,
``--clip-g``, ``--t5`` torch weights or random ones), ``--prompt`` (raw
text through the port's tokenizers, with ``--clip-vocab``,
``--clip-merges`` and ``--spm``), or synthetic embeddings.  ``--ckpt`` and
``--vae`` load HF weights.  Runs on the card by default:

    python -m naturaldiffusion_tpu_torch.apps.sd3_ni --steps 28 --vae v.pth
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch

from ..coeffs.sd3 import flow_match_sigmas, sd3_weight_matrix
from ..device import resolve_device
from ..engine import NISchedule, natural_inference
from ..models.mmdit import MMDiT, MMDiTConfig, mmdit_cfg_fwd_mods

# the JAX app's --small MMDiT (``naturaldiffusion_tpu/apps/sd3_ni.py:
# 401``): 4 heads of 32
SMALL = MMDiTConfig(hidden_size=128, depth=2, num_heads=4,
                    joint_attention_dim=64, pooled_projection_dim=64)


def load_weight_csv(path: str) -> np.ndarray:
    """An SD3 weight CSV (``weights/sd3_step_28_weight[_sharp].csv``): a
    header row and an index column, both dropped (pandas' ``read_csv(path,
    index_col=0)``)."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return np.array([[float(v) for v in r[1:]] for r in rows[1:] if r],
                    np.float64)


def _cfg_pair(context, pooled, neg_context, neg_pooled):
    return (torch.cat([context, neg_context]),
            torch.cat([pooled, neg_pooled]))


def make_cfg_fwd(model, *, context, pooled, neg_context, neg_pooled,
                 cfg_scale: float = 7.0):
    """CFG-fused velocity predictor ``(z, t) -> v`` for the NI engine.

    The reference fuses at the x0 level (``src/SD3NaturalInference.py:
    215-217``); since ``x0 = z - sigma * v`` that equals fusing the
    velocities, which keeps the engine's ``v_flow`` conversion."""
    ctx2, pool2 = _cfg_pair(context, pooled, neg_context, neg_pooled)

    def fwd(z, t):
        b = z.shape[0]
        # the timestep stays f32: bf16 spaces ~1000-scale times 4 apart
        t2 = torch.as_tensor(t, dtype=torch.float32,
                             device=z.device).reshape(1).expand(2 * b)
        v2 = model(torch.cat([z, z]), t2, ctx2, pool2)
        text_v, null_v = v2[:b], v2[b:]
        return null_v + cfg_scale * (text_v - null_v)

    return fwd


def make_cfg_fwd_mods(model, *, context, pooled, neg_context, neg_pooled,
                      t_all, cfg_scale: float = 7.0):
    """CFG-fused predictor with the schedule's conditioning hoisted
    (``models.mmdit.mmdit_cfg_fwd_mods``): ``(fwd(z, t, aux),
    step_inputs)`` for the engine's ``step_inputs=``."""
    ctx2, pool2 = _cfg_pair(context, pooled, neg_context, neg_pooled)
    return mmdit_cfg_fwd_mods(model, ctx2=ctx2, pool2=pool2, t_all=t_all,
                              cfg_scale=cfg_scale)


@torch.no_grad()
def sd3_natural_inference(model, noises, weights, *, context, pooled,
                          neg_context, neg_pooled, num_step: int = 28,
                          cfg_scale: float = 7.0, shift: float = 3.0,
                          precompute_mods: bool = True):
    """SD3 NI as one engine run over ``sd3_weight_matrix(weights)``: the
    sigma re-projection is affine, so it is a deterministic NI schedule.
    The model runs in ``noises``' type, the sums in float32; returns the
    float32 latents.  ``precompute_mods`` hoists the timestep embeddings
    and every adaLN modulation out of the loop (the same math)."""
    sched = NISchedule.from_matrix(
        sd3_weight_matrix(weights, num_step, shift=shift),
        device=noises.device)
    kw = dict(context=context, pooled=pooled, neg_context=neg_context,
              neg_pooled=neg_pooled, cfg_scale=cfg_scale)
    if precompute_mods:
        fwd, aux = make_cfg_fwd_mods(model, t_all=sched.node[:num_step, 0],
                                     **kw)
    else:
        fwd, aux = make_cfg_fwd(model, **kw), None
    return natural_inference(fwd, sched, noises, prediction_type="v_flow",
                             step_inputs=aux)


@torch.no_grad()
def sd3_natural_inference_host(model, noises, weights, *, context, pooled,
                               neg_context, neg_pooled, num_step: int = 28,
                               cfg_scale: float = 7.0):
    """The reference-shaped loop (``src/SD3NaturalInference.py:201-223``):
    two model calls a step, CFG on the x0's, the weighted x0 history summed
    on the host in the model's type; the oracle of the engine path."""
    timesteps, sigmas = flow_match_sigmas(num_step)
    seq_x0: list = []
    b = noises.shape[0]

    def weighted_sum(seq):
        n = len(seq)
        acc = torch.zeros_like(seq[0])
        tot = 0.0
        for i, arr in enumerate(seq):
            w = float(weights[n - 1][i])
            acc = acc + arr * w
            tot += w
        return acc / tot

    for k in range(num_step):
        t = torch.full((b,), float(timesteps[k]), dtype=torch.float32,
                       device=noises.device)
        sigma = float(sigmas[k])
        curr_x0 = weighted_sum(seq_x0) if seq_x0 else torch.zeros_like(noises)
        model_in = sigma * noises + (1.0 - sigma) * curr_x0
        text_v = model(model_in, t, context, pooled)
        null_v = model(model_in, t, neg_context, neg_pooled)
        text_x0 = model_in - sigma * text_v
        null_x0 = model_in - sigma * null_v
        seq_x0.append(null_x0 + cfg_scale * (text_x0 - null_x0))
    return weighted_sum(seq_x0)


def _tokenize_prompt(args):
    """Raw text -> the ids dict through the port's tokenizers (CLIP
    byte-level BPE, T5 sentencepiece unigram), the last stage of the
    reference's prompt path (``src/SD3NaturalInference.py:184``)."""
    from ..text import CLIPBPETokenizer, SentencePieceUnigram, sd3_tokenize_ids
    clip = CLIPBPETokenizer.from_files(args.clip_vocab, args.clip_merges)
    t5 = SentencePieceUnigram.from_file(args.spm) if args.spm else None
    return sd3_tokenize_ids(args.prompt, args.neg_prompt or "",
                            clip_l=clip, t5=t5)


def _load_into(model, path, path_map):
    from ..models.convert import fill_from_torch, load_torch_checkpoint
    unused = fill_from_torch(model, load_torch_checkpoint(path),
                             path_map=path_map)
    print(f"loaded {path} ({len(unused)} unused keys)", flush=True)
    return model


def _encode_prompt_from_ids(args, dev, ids=None):
    """Token ids (an npz file or a dict) through the port's CLIP-L, CLIP-G
    and, with ``ids_t5``, T5-XXL encoders (torch weights from ``--clip-l``,
    ``--clip-g``, ``--t5``, else random) -> ``(ctx, pooled, neg_ctx,
    neg_pooled)``."""
    from ..models.text_encoders import (CLIP_G_SD3, CLIP_L_SD3, T5_XXL,
                                        CLIPTextEncoder, T5Encoder,
                                        clip_torch_path_map,
                                        sd3_encode_prompt, t5_torch_path_map)
    if ids is None:
        with np.load(args.ids) as f:
            ids = {k: f[k] for k in f.files}
    ids = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=dev)
           for k, v in ids.items()}

    def enc(cls, cfg, path, path_map):
        model = cls(cfg, device=dev)
        if path:
            return _load_into(model, path, path_map)
        print("WARNING: random text-encoder weights (smoke mode)",
              flush=True)
        return model

    cl = enc(CLIPTextEncoder, CLIP_L_SD3, args.clip_l, clip_torch_path_map)
    cg = enc(CLIPTextEncoder, CLIP_G_SD3, args.clip_g, clip_torch_path_map)
    t5 = None
    if "ids_t5" in ids:
        t5 = enc(T5Encoder, T5_XXL, args.t5, t5_torch_path_map)
    with torch.no_grad():
        ctx, pooled = sd3_encode_prompt(cl, ids["ids_l"], cg, ids["ids_g"],
                                        t5, ids.get("ids_t5"))
        neg_t5 = ids.get("neg_ids_t5")
        if t5 is not None and neg_t5 is None:
            # the empty negative prompt: T5 tokenizes "" to [EOS(1), pad(0)
            # ...], not all zeros (T5 runs unmasked, so the EOS counts)
            neg_t5 = torch.zeros_like(ids["ids_t5"])
            neg_t5[:, 0] = 1
        nctx, npooled = sd3_encode_prompt(cl, ids["neg_ids_l"], cg,
                                          ids["neg_ids_g"], t5, neg_t5)
    return ctx, pooled, nctx, npooled


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", default=None,
                   help="weight CSV (weights/sd3_step_28_weight[_sharp].csv)")
    p.add_argument("--embeds", default=None, help="precomputed text embeds npz")
    p.add_argument("--ids", default=None,
                   help="token-ids npz (ids_l/ids_g/ids_t5 + neg_*) for the "
                        "port's encode_prompt")
    p.add_argument("--prompt", default=None,
                   help="raw text prompt (needs --clip-vocab/--clip-merges"
                        " [+ --spm])")
    p.add_argument("--neg-prompt", default="",
                   help="raw negative prompt (default: empty)")
    p.add_argument("--clip-vocab", default=None, help="CLIP vocab.json")
    p.add_argument("--clip-merges", default=None, help="CLIP merges.txt")
    p.add_argument("--spm", default=None, help="T5 spiece.model")
    p.add_argument("--clip-l", default=None, help="CLIP-L torch weights")
    p.add_argument("--clip-g", default=None, help="CLIP-G torch weights")
    p.add_argument("--t5", default=None, help="T5-XXL encoder torch weights")
    p.add_argument("--ckpt", default=None, help="SD3 transformer torch weights")
    p.add_argument("--vae", default=None, help="SD3 VAE torch weights")
    p.add_argument("--steps", type=int, default=28)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--latent", type=int, default=128,
                   help="latent H=W (128 = 1024px)")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--small", action="store_true",
                   help="tiny random model (smoke mode)")
    p.add_argument("--outdir", default="samples/sd3")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = SMALL if args.small else MMDiTConfig()
    model = MMDiT(cfg, device=dev)
    if args.ckpt:
        from ..models.mmdit import mmdit_torch_path_map
        _load_into(model, args.ckpt, mmdit_torch_path_map)
    b, hw = args.batch, args.latent
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noises = torch.randn((b, hw, hw, cfg.in_channels), generator=gen,
                         device=dev)

    if args.embeds:
        with np.load(args.embeds) as f:
            ctx, pooled, nctx, npooled = (
                torch.as_tensor(f[k], device=dev) for k in (
                    "prompt_embeds", "pooled", "negative_prompt_embeds",
                    "negative_pooled"))
    elif args.prompt is not None:
        if not (args.clip_vocab and args.clip_merges):
            raise SystemExit("--prompt needs --clip-vocab and --clip-merges")
        ctx, pooled, nctx, npooled = _encode_prompt_from_ids(
            args, dev, ids=_tokenize_prompt(args))
    elif args.ids:
        ctx, pooled, nctx, npooled = _encode_prompt_from_ids(args, dev)
    else:
        ctx = 0.02 * torch.randn((b, 77, cfg.joint_attention_dim),
                                 generator=gen, device=dev)
        pooled = 0.02 * torch.randn((b, cfg.pooled_projection_dim),
                                    generator=gen, device=dev)
        nctx, npooled = torch.zeros_like(ctx), torch.zeros_like(pooled)

    weights = load_weight_csv(args.weights) if args.weights \
        else np.tril(np.ones((args.steps, args.steps)))
    x0 = sd3_natural_inference(model, noises, weights, context=ctx,
                               pooled=pooled, neg_context=nctx,
                               neg_pooled=npooled, num_step=args.steps)

    # the weights' provenance in every artifact's name: random-weight
    # outputs must not pass for converted-weight ones
    prov = "converted" if args.ckpt else "random"
    os.makedirs(args.outdir, exist_ok=True)
    lat_path = os.path.join(args.outdir, f"latents_{prov}.npy")
    lat = x0.float().cpu().numpy()
    np.save(lat_path, lat)
    with open(os.path.join(args.outdir, "meta.json"), "w") as fh:
        json.dump({"weights": prov, "ckpt": args.ckpt, "vae": args.vae,
                   "text_encoders": "converted" if (args.clip_l or args.t5)
                   else ("embeds" if args.embeds else "random"),
                   "steps": args.steps, "seed": args.seed,
                   "device": str(dev)}, fh, indent=1)
    print(f"latents -> {lat_path} (weights={prov}, "
          f"finite={bool(np.isfinite(lat).all())})", flush=True)

    if args.vae:
        from ..models.vae import SD3_VAE, AutoencoderKL, vae_torch_path_map
        from ..utils.plotting import save_image_grid
        vae = _load_into(AutoencoderKL(SD3_VAE, device=dev), args.vae,
                         vae_torch_path_map)
        with torch.no_grad():
            imgs = vae.decode(vae.unscale_latents(x0))
        grid = os.path.join(args.outdir, f"grid_{prov}.png")
        save_image_grid(imgs, grid, nrow=4)
        print(f"decoded -> {grid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
