"""Operations and bytes of an SD3-medium request, from the shapes.

A request: ``encode_prompt`` twice (prompt and empty negative; CLIP-L,
CLIP-G and T5-XXL, batch 1), the conditioning the pipeline hoists out of
the NI loop (timestep and pooled MLPs and every adaLN product at all
steps, the context embedder), ``steps`` CFG forwards of the MMDiT at model
batch ``2 * batch``, and the VAE decode of ``batch`` latents.  FLOPs are 2
per multiply-add, as PyTorch's ``FlopCounterMode`` counts them
(``benchmark/tests`` holds each part equal to it on the reference at small
sizes).  ``cfg_forward_flops`` is a copy of ``apps/bench_sd3.py:
flops_per_forward`` with ``mods``.
"""

from __future__ import annotations

BF16 = 2


def clip_flops(c, tokens, batch=1):
    d, t = c["hidden_size"], tokens
    per = (2 * t * d * d * 4 + 4 * t * t * d
           + 4 * t * d * c["intermediate_size"])
    return batch * (c["num_layers"] * per + 2 * d * c["projection_dim"])


def t5_flops(c, tokens, batch=1):
    d, t, inner = c["d_model"], tokens, c["num_heads"] * c["d_kv"]
    per = 2 * t * d * inner * 4 + 4 * t * t * inner + 6 * t * d * c["d_ff"]
    return batch * c["num_layers"] * per


def cfg_forward_flops(m, batch, latent, ctx):
    """One CFG forward at model batch ``2 * batch`` with the conditioning
    hoisted (``mods``)."""
    b2 = 2 * batch
    d, p, c = m["hidden_size"], m["patch_size"], m["in_channels"]
    tx = (latent // p) ** 2
    t = tx + ctx
    mx, mc = b2 * tx, b2 * ctx
    total = 2 * mx * p * p * c * d
    for i in range(m["depth"]):
        last = i == m["depth"] - 1
        total += 2 * mx * d * (3 * d + d + 8 * d)
        total += 2 * mc * d * (3 * d + (0 if last else d + 8 * d))
        total += 4 * b2 * t * t * d
    return total + 2 * mx * d * p * p * c


def hoisted_flops(m, batch, ctx, steps):
    """The conditioning computed once a request for all ``steps``."""
    rows, d, depth = steps * 2 * batch, m["hidden_size"], m["depth"]
    total = 2 * rows * (256 * d + d * d + m["pooled_projection_dim"] * d
                        + d * d)
    total += 2 * rows * d * d * (6 * depth + 6 * (depth - 1) + 2 + 2)
    return total + 2 * 2 * batch * ctx * m["joint_attention_dim"] * d


def mmdit_forward_flops(m, batch, latent, ctx):
    """One forward without hoisting, at model batch ``batch``: what the
    reference's ``MMDiT.forward`` computes."""
    return (cfg_forward_flops(m, batch / 2, latent, ctx)
            + hoisted_flops(m, batch / 2, ctx, 1))


def vae_decode_flops(v, batch, latent):
    ch, mults = v["base_channels"], list(reversed(v["ch_mult"]))
    h = latent

    def conv(cin, cout, hw, k=3):
        return 2 * batch * hw * hw * k * k * cin * cout

    def resnet(cin, cout, hw):
        f = conv(cin, cout, hw) + conv(cout, cout, hw)
        return f + (conv(cin, cout, hw, 1) if cin != cout else 0)

    c = ch * mults[0]
    lc = v["latent_channels"]
    total = conv(lc, lc, h, 1) + conv(lc, c, h)
    n = h * h
    total += 2 * resnet(c, c, h) + 2 * batch * n * c * c * 4 \
        + 4 * batch * n * n * c
    for i, mult in enumerate(mults):
        for _ in range(v["layers_per_block"] + 1):
            total += resnet(c, ch * mult, h)
            c = ch * mult
        if i != len(mults) - 1:
            h *= 2
            total += conv(c, c, h)
    return total + conv(c, v["in_channels"], h)


def request_flops(spec, traffic):
    m, ctx = spec["mmdit"], spec["clip_tokens"] + spec["t5_tokens"]
    b, lat, steps = traffic["batch"], traffic["latent"], spec["steps"]
    enc = (clip_flops(spec["clip_l"], spec["clip_tokens"])
           + clip_flops(spec["clip_g"], spec["clip_tokens"])
           + t5_flops(spec["t5"], spec["t5_tokens"]))
    return (2 * enc + hoisted_flops(m, b, ctx, steps)
            + steps * cfg_forward_flops(m, b, lat, ctx)
            + vae_decode_flops(spec["vae"], b, lat))


def attention_least_s(spec, traffic, least):
    """The least seconds of one request's joint attentions (kernel K9):
    ``4 b t^2 d`` operations and q, k, v, o read or written once, a layer
    and CFG forward."""
    m = spec["mmdit"]
    b2, d = 2 * traffic["batch"], m["hidden_size"]
    t = (traffic["latent"] // m["patch_size"]) ** 2 + spec["clip_tokens"] \
        + spec["t5_tokens"]
    one = least(4 * b2 * t * t * d, 4 * BF16 * b2 * t * d)
    return spec["steps"] * m["depth"] * one
