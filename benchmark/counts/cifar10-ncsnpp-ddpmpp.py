"""Operations and bytes of the CIFAR NCSN++ DDPM++ net, from its shapes.

One walk over the network (as ``benchmark/reference/ncsnpp.py`` builds it)
lists every product with its shapes: the time-embedding MLP, the 3x3 convs
(stem, each BigGAN block's two, the head), the 1x1 shortcut convs, each
block's time projection, the attention blocks' four 1x1 products and their
two attention products.  FLOPs are 2 per multiply-add, as PyTorch's
``FlopCounterMode`` counts them (``benchmark/tests`` holds the two equal on
the reference).  The standalone GroupNorms are those the port runs as
kernel K6 on its default route: each attention block's, each resampling
block's first, and the head's; the other GroupNorms ride the fused convs.
Bytes count each input and output once, in bfloat16 (the scales and biases
of the GroupNorm in float32).
"""

from __future__ import annotations

BF16 = 2


def walk(spec, batch):
    """-> dict of lists: ``conv3x3`` (b, h, w, cin, cout, skip), ``conv1x1``
    and ``dense`` (m, k, n), ``attention`` (b, tokens, c), ``gn_k6``
    (b, h, w, c)."""
    nf, mults = spec["nf"], spec["ch_mult"]
    nrb, attn = spec["num_res_blocks"], spec["attn_resolutions"]
    res, nc = spec["image_size"], spec["num_channels"]
    temb = 4 * nf
    out = {"conv3x3": [], "conv1x1": [], "dense": [], "attention": [],
           "gn_k6": []}
    out["dense"] += [(batch, nf, temb), (batch, temb, temb)]
    out["conv3x3"].append((batch, res, res, nc, nf, False))

    def block(cin, cout, r, up=False, down=False):
        r2 = 2 * r if up else (r // 2 if down else r)
        if up or down:
            out["gn_k6"].append((batch, r, r, cin))
        out["conv3x3"].append((batch, r2, r2, cin, cout, False))
        out["dense"].append((batch, temb, cout))
        out["conv3x3"].append((batch, r2, r2, cout, cout, True))
        if cin != cout or up or down:
            out["conv1x1"].append((batch * r2 * r2, cin, cout))
        return r2

    def attend(c, r):
        out["gn_k6"].append((batch, r, r, c))
        out["conv1x1"] += [(batch * r * r, c, c)] * 4
        out["attention"].append((batch, r * r, c))

    hs, cin = [nf], nf
    for lvl, mult in enumerate(mults):
        for _ in range(nrb):
            block(cin, nf * mult, res)
            cin = nf * mult
            if res in attn:
                attend(cin, res)
            hs.append(cin)
        if lvl != len(mults) - 1:
            res = block(cin, cin, res, down=True)
            hs.append(cin)
    block(cin, cin, res)
    attend(cin, res)
    block(cin, cin, res)
    for lvl in reversed(range(len(mults))):
        for _ in range(nrb + 1):
            block(cin + hs.pop(), nf * mults[lvl], res)
            cin = nf * mults[lvl]
        if res in attn:
            attend(cin, res)
        if lvl != 0:
            res = block(cin, cin, res, up=True)
    out["gn_k6"].append((batch, res, res, cin))
    out["conv3x3"].append((batch, res, res, cin, nc, False))
    return out


def conv3x3_cost(b, h, w, cin, cout, skip):
    """(flops, bytes) of one 3x3 SAME conv; ``skip``: the fused residual
    input read as well."""
    flops = 2 * b * h * w * 9 * cin * cout
    nbytes = BF16 * (b * h * w * cin + 9 * cin * cout + cout
                     + b * h * w * cout * (2 if skip else 1))
    return flops, nbytes


def forward_flops(spec, batch):
    """FLOPs of one forward at ``batch`` images."""
    w = walk(spec, batch)
    total = sum(conv3x3_cost(*c)[0] for c in w["conv3x3"])
    total += sum(2 * m * k * n for m, k, n in w["conv1x1"] + w["dense"])
    total += sum(4 * b * t * t * c for b, t, c in w["attention"])
    return total


def request_flops(spec, traffic):
    """FLOPs of one request: a sweep of ``sweep`` images in micro-batches,
    ``steps`` forwards each (the NI sums are not products)."""
    per = forward_flops(spec, traffic["micro"])
    return per * spec["steps"] * traffic["sweep"] // traffic["micro"]


def _forwards(spec, traffic):
    return spec["steps"] * traffic["sweep"] // traffic["micro"]


def conv3x3_least_s(spec, traffic, least):
    """The least seconds of one request's 3x3 convs, each conv bounded by
    ``least(flops, bytes)``."""
    w = walk(spec, traffic["micro"])
    return _forwards(spec, traffic) * sum(least(*conv3x3_cost(*c))
                                          for c in w["conv3x3"])


def group_norm_least_s(spec, traffic, least):
    """The least seconds of one request's standalone GroupNorms (kernel
    K6): read x, write y, with SiLU; ~10 operations an element."""
    w = walk(spec, traffic["micro"])
    total = 0.0
    for b, h, ww, c in w["gn_k6"]:
        n = b * h * ww * c
        total += least(10 * n, 2 * BF16 * n + 2 * 4 * c)
    return _forwards(spec, traffic) * total
