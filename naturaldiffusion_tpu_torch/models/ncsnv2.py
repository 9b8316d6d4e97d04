"""NCSNv2 and NCSN, the RefineNet score networks, in PyTorch, NHWC (port of
``naturaldiffusion_tpu/models/ncsnv2.py``, itself a rebuild of
``deps/score_sde_pytorch/models/ncsnv2.py`` and its layers).

Every conv here is a library conv (``F.conv2d`` on channels-last views,
cuDNN on the card), kernel ``[k, k, in, out]``, as the JAX package computes
them with ``nn.Conv`` and reaches no Pallas kernel.  That includes the
dilated ones, padded by their dilation (the upstream ncsnv2 semantics the
JAX package keeps; its module note says why).  The normalisations and
pools are plain PyTorch, statistics in float32.

The unconditional blocks (``InstanceNormPlus``, ``ResidualBlock``,
``CRPBlock``, ``RCUBlock``, ``MSFBlock``, ``RefineBlock``) take
``num_classes``: given, each is the JAX package's conditional twin of NCSN
v1 (``CondInstanceNormPlus`` from a per-class embedding, norms before each
conv, and the CRP averaging where the unconditional one max-pools), and
its forward takes the labels.  Module and parameter names are the JAX
package's, so :func:`.convert.load_jax_params` carries a flax tree across
as it is, and :func:`.convert.fill_from_torch` with
:func:`ncsnv2_torch_path_map` a reference state dict.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import layers as L
from .dit import Embed

_EPS = 1e-5


class Conv(nn.Module):
    """``flax.linen.Conv`` in NHWC: kernel ``[k, k, in, out]`` (and
    ``bias``), stride 1, ``padding`` on each side, ``dilation``; one
    library conv in x's type."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3,
                 padding: int | None = None, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, in_ch, out_ch))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_ch))
        else:
            self.register_parameter("bias", None)
        self.padding = k // 2 if padding is None else padding
        self.dilation = dilation

    def reset_parameters(self, generator):
        L.variance_scaling_(self.kernel, 1.0, generator)

    def forward(self, x):
        w = self.kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=self.padding,
                     dilation=self.dilation)
        return y.permute(0, 2, 3, 1).contiguous()


def _conv3(in_ch, out_ch, dilation: int = 1, bias: bool = True):
    return Conv(in_ch, out_ch, 3, padding=dilation, dilation=dilation,
                bias=bias)


def _instance_stats(xf):
    """InstanceNorm++'s two statistics of float32 ``xf`` [B, H, W, C]: the
    normalised channel means (their variance across channels unbiased, as
    torch's ``var``) and the instance-normalised map (biased variance, as
    torch's InstanceNorm), both with eps 1e-5."""
    means = xf.mean(dim=(1, 2))
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    means_n = (means - m) / torch.sqrt(v + _EPS)
    mu = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
    return means_n[:, None, None, :], (xf - mu) / torch.sqrt(var + _EPS)


class InstanceNormPlus(nn.Module):
    """InstanceNorm2d++ (JAX ``ncsnv2.py:35``): ``gamma * (IN(x) +
    alpha * normalised channel means) + beta``; output in x's type.
    Initialised as the reference (alpha, gamma ~ N(1, 0.02), beta 0)."""

    def __init__(self, channels: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels))
        if bias:
            self.beta = nn.Parameter(torch.zeros(channels))
        else:
            self.register_parameter("beta", None)

    def reset_parameters(self, generator):
        with torch.no_grad():
            for p in (self.alpha, self.gamma):
                p.normal_(1.0, 0.02, generator=generator)

    def forward(self, x):
        means_n, h = _instance_stats(x.float())
        out = self.gamma * (h + means_n * self.alpha)
        if self.beta is not None:
            out = out + self.beta
        return out.to(x.dtype)


class CondInstanceNormPlus(nn.Module):
    """Class-conditional InstanceNorm++ (JAX ``ncsnv2.py:418``): gamma,
    alpha (and beta), in that order, split from the label's row of
    ``embed``; labels truncated to integers.  Initialised as the
    reference (gamma, alpha ~ N(1, 0.02), beta 0)."""

    def __init__(self, channels: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.bias, self.channels = bias, channels
        self.embed = Embed(num_classes, (3 if bias else 2) * channels)

    def reset_parameters(self, generator):
        with torch.no_grad():
            e = self.embed.embedding
            e[:, :2 * self.channels].normal_(1.0, 0.02, generator=generator)
            e[:, 2 * self.channels:].zero_()

    def forward(self, x, y):
        means_n, h = _instance_stats(x.float())
        e = self.embed(y.long()).float()[:, None, None, :]
        parts = e.chunk(3 if self.bias else 2, dim=-1)
        out = parts[0] * (h + means_n * parts[1])
        if self.bias:
            out = out + parts[2]
        return out.to(x.dtype)


def _norm(channels, num_classes):
    return (InstanceNormPlus(channels) if num_classes is None
            else CondInstanceNormPlus(channels, num_classes))


def _apply(norm, x, y):
    return norm(x) if y is None else norm(x, y)


class ConvMeanPool(nn.Module):
    """A conv (``conv``), then the mean of each 2x2 block (JAX
    ``ncsnv2.py:62``); ``adjust_padding`` first pads one row and column at
    the top and left."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = Conv(in_ch, out_ch, kernel)

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (0, 0, 1, 0, 1, 0))
        y = self.conv(x)
        return (y[:, ::2, ::2] + y[:, 1::2, ::2] + y[:, ::2, 1::2]
                + y[:, 1::2, 1::2]) / 4.0


class ResidualBlock(nn.Module):
    """The RefineNet residual block with ELU and InstanceNorm++ (JAX
    ``ncsnv2.py:79``; with ``num_classes`` its ``CondResidualBlock``):
    ``resample="down"`` halves the map through ``ConvMeanPool`` where
    ``dilation`` is 1 and keeps it (a dilated conv) otherwise."""

    def __init__(self, in_ch: int, out_ch: int, resample: str | None = None,
                 dilation: int = 1, adjust_padding: bool = False,
                 num_classes: int | None = None):
        super().__init__()
        self.normalize1 = _norm(in_ch, num_classes)
        if resample == "down":
            self.conv1 = _conv3(in_ch, in_ch, dilation)
            self.normalize2 = _norm(in_ch, num_classes)
            if dilation > 1:
                self.conv2 = _conv3(in_ch, out_ch, dilation)
                self.shortcut = _conv3(in_ch, out_ch, dilation)
            else:
                self.conv2 = ConvMeanPool(in_ch, out_ch,
                                          adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(in_ch, out_ch, kernel=1,
                                             adjust_padding=adjust_padding)
        else:
            self.conv1 = _conv3(in_ch, out_ch, dilation)
            self.normalize2 = _norm(out_ch, num_classes)
            self.conv2 = _conv3(out_ch, out_ch, dilation)
            if in_ch != out_ch:
                self.shortcut = (_conv3(in_ch, out_ch, dilation)
                                 if dilation > 1 else Conv(in_ch, out_ch, 1))

    def forward(self, x, y=None):
        h = self.conv1(F.elu(_apply(self.normalize1, x, y)))
        h = self.conv2(F.elu(_apply(self.normalize2, h, y)))
        sc = self.shortcut(x) if hasattr(self, "shortcut") else x
        return sc + h


class CRPBlock(nn.Module):
    """Chained residual pooling (JAX ``ncsnv2.py:126``): ELU, then
    ``n_stages`` times a 5x5 stride-1 pool padded by 2 (max, padding
    -inf; or with ``num_classes`` the ``CondCRPBlock``'s norm then average,
    dividing by 25 over the padding too) and a bias-free conv, each added to
    the running sum."""

    def __init__(self, channels: int, n_stages: int = 2,
                 num_classes: int | None = None):
        super().__init__()
        self.n_stages = n_stages
        self.cond = num_classes is not None
        for i in range(n_stages):
            if self.cond:
                setattr(self, f"norms_{i}",
                        CondInstanceNormPlus(channels, num_classes))
            setattr(self, f"convs_{i}", _conv3(channels, channels,
                                               bias=False))

    def forward(self, x, y=None):
        x = F.elu(x)
        path = x
        for i in range(self.n_stages):
            if self.cond:
                p = getattr(self, f"norms_{i}")(path, y).permute(0, 3, 1, 2)
                p = F.avg_pool2d(p, 5, stride=1, padding=2)
            else:
                p = F.max_pool2d(path.permute(0, 3, 1, 2), 5, stride=1,
                                 padding=2)
            path = getattr(self, f"convs_{i}")(p.permute(0, 2, 3, 1))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units (JAX ``ncsnv2.py:150``): ``n_blocks`` residual
    units of ``n_stages`` ELU + bias-free conv (with ``num_classes`` the
    ``CondRCUBlock``: a conditional norm before each ELU)."""

    def __init__(self, channels: int, n_blocks: int, n_stages: int = 2,
                 num_classes: int | None = None):
        super().__init__()
        self.n_blocks, self.n_stages = n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                if num_classes is not None:
                    setattr(self, f"b{i + 1}_{j + 1}_norm",
                            CondInstanceNormPlus(channels, num_classes))
                setattr(self, f"b{i + 1}_{j + 1}_conv",
                        _conv3(channels, channels, bias=False))

    def forward(self, x, y=None):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                if y is not None:
                    x = getattr(self, f"b{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"b{i + 1}_{j + 1}_conv")(F.elu(x))
            x = x + residual
        return x


@functools.lru_cache(maxsize=64)
def _axis_weights(n_in: int, n_out: int):
    """align_corners bilinear sampling along one axis: the lower and upper
    source indices and the float32 weight of the upper one."""
    pos = (np.linspace(0.0, n_in - 1.0, n_out) if n_out > 1
           else np.zeros(1))
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (pos - lo).astype(np.float32)


def _bilinear_align_corners(x, out_hw):
    """``F.interpolate(mode="bilinear", align_corners=True)`` of NHWC ``x``
    to ``out_hw``: the weights computed in float32 on the host and applied
    in the JAX package's order (``ncsnv2.py:168``), in float32 where x is
    narrower; output in x's type."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x

    def t(a):
        return torch.as_tensor(a, device=x.device)

    ylo, yhi, yf = map(t, _axis_weights(h, oh))
    xlo, xhi, xf = map(t, _axis_weights(w, ow))
    yf, xf = yf[None, :, None, None], xf[None, None, :, None]
    rows_lo, rows_hi = x[:, ylo], x[:, yhi]
    top = rows_lo[:, :, xlo] * (1 - xf) + rows_lo[:, :, xhi] * xf
    bot = rows_hi[:, :, xlo] * (1 - xf) + rows_hi[:, :, xhi] * xf
    return (top * (1 - yf) + bot * yf).to(x.dtype)


class MSFBlock(nn.Module):
    """Multi-scale fusion (JAX ``ncsnv2.py:193``): each input through its
    conv (after its conditional norm with ``num_classes``), resized to the
    output's map and summed."""

    def __init__(self, in_chs, features: int,
                 num_classes: int | None = None):
        super().__init__()
        self.features = features
        for i, c in enumerate(in_chs):
            if num_classes is not None:
                setattr(self, f"norms_{i}",
                        CondInstanceNormPlus(c, num_classes))
            setattr(self, f"convs_{i}", _conv3(c, features))

    def forward(self, xs, shape, y=None):
        total = torch.zeros((xs[0].shape[0], *shape, self.features),
                            dtype=xs[0].dtype, device=xs[0].device)
        for i, xi in enumerate(xs):
            if y is not None:
                xi = getattr(self, f"norms_{i}")(xi, y)
            h = getattr(self, f"convs_{i}")(xi)
            total = total + _bilinear_align_corners(h, shape)
        return total


class RefineBlock(nn.Module):
    """RefineNet block (JAX ``ncsnv2.py:207``; ``CondRefineBlock`` with
    ``num_classes``): two RCUs on each input, multi-scale fusion where there
    are several, chained residual pooling, and 1 RCU (3 at the ``end``)."""

    def __init__(self, in_chs, features: int, end: bool = False,
                 num_classes: int | None = None):
        super().__init__()
        for i, c in enumerate(in_chs):
            setattr(self, f"adapt_convs_{i}",
                    RCUBlock(c, 2, 2, num_classes=num_classes))
        self.n_inputs = len(in_chs)
        ch = in_chs[0]
        if self.n_inputs > 1:
            self.msf = MSFBlock(in_chs, features, num_classes=num_classes)
            ch = features
        self.crp = CRPBlock(ch, 2, num_classes=num_classes)
        self.output_convs = RCUBlock(ch, 3 if end else 1, 2,
                                     num_classes=num_classes)

    def forward(self, xs, output_shape, y=None):
        hs = [getattr(self, f"adapt_convs_{i}")(x, y)
              for i, x in enumerate(xs)]
        h = (self.msf(hs, output_shape, y) if self.n_inputs > 1
             else hs[0])
        return self.output_convs(self.crp(h, y), y)


@dataclasses.dataclass(frozen=True)
class NCSNv2Config:
    image_size: int = 32
    num_channels: int = 3
    nf: int = 128
    centered: bool = False
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 232          # ncsnv2 cifar10 convention


class _RefineNet(nn.Module):
    """The RefineNet walk the four networks share.  ``LEVELS``: per level
    its name, channel multiple, dilation and whether its first block
    downsamples (each level is two ResidualBlocks, ``res{name}_0/1``);
    ``REFINES``: per refine block, deepest first, its name and channel
    multiple (each takes its level's output and the previous refine's).
    ``forward(x [B,H,W,C], labels [B])``; the v2 networks divide by the
    geometric sigma table at the labels (truncated to integers), NCSN
    does not (its loss carries the scale).  Weights random from ``seed``;
    lands on ``device`` (default ``"cuda"``, which raises without a
    card)."""

    LEVELS: tuple = ()
    REFINES: tuple = ()
    conditional = False

    def __init__(self, config: NCSNv2Config = NCSNv2Config(), *,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        nf = cfg.nf
        ncls = cfg.num_scales if self.conditional else None
        adj = cfg.image_size == 28
        self.begin_conv = Conv(cfg.num_channels, nf)
        ch, chs = nf, []
        for name, mult, dil, down in self.LEVELS:
            out = mult * nf
            setattr(self, f"res{name}_0", ResidualBlock(
                ch, out, resample="down" if down else None, dilation=dil,
                adjust_padding=adj and dil == 4, num_classes=ncls))
            setattr(self, f"res{name}_1", ResidualBlock(
                out, out, dilation=dil, num_classes=ncls))
            ch = out
            chs.append(out)
        prev = None
        for i, (name, mult) in enumerate(self.REFINES):
            lvl = chs[len(chs) - 1 - i]
            ins = [lvl] if prev is None else [lvl, prev]
            setattr(self, f"refine{name}", RefineBlock(
                ins, mult * nf, end=i == len(self.REFINES) - 1,
                num_classes=ncls))
            prev = mult * nf if len(ins) > 1 else lvl
        self.normalizer = _norm(prev, ncls)
        self.end_conv = Conv(prev, cfg.num_channels)

        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "reset_parameters") and m is not self:
                m.reset_parameters(gen)
        self.to(dev)

    def forward(self, x, labels):
        cfg = self.config
        y = labels if self.conditional else None
        h = x if cfg.centered else 2 * x - 1.0
        h = self.begin_conv(h)
        levels = []
        for name, *_ in self.LEVELS:
            h = getattr(self, f"res{name}_0")(h, y)
            h = getattr(self, f"res{name}_1")(h, y)
            levels.append(h)
        r = None
        for i, (name, _) in enumerate(self.REFINES):
            lvl = levels[len(levels) - 1 - i]
            ins = [lvl] if r is None else [lvl, r]
            r = getattr(self, f"refine{name}")(ins, tuple(lvl.shape[1:3]), y)
        out = self.end_conv(F.elu(_apply(self.normalizer, r, y)))
        if self.conditional:
            return out
        table = torch.exp(torch.linspace(
            math.log(cfg.sigma_max), math.log(cfg.sigma_min),
            cfg.num_scales, dtype=torch.float32, device=labels.device))
        used = table[labels.long()].to(out.dtype)
        return out / used.reshape(-1, 1, 1, 1)


class NCSNv2(_RefineNet):
    """The <96px NCSNv2 (JAX ``ncsnv2.py:239``): four levels (nf, 2nf, 2nf
    dilated 2, 2nf dilated 4), ``adjust_padding`` at 28x28."""
    LEVELS = (("1", 1, 1, False), ("2", 2, 1, True), ("3", 2, 2, True),
              ("4", 2, 4, True))
    REFINES = (("1", 2), ("2", 2), ("3", 1), ("4", 1))


class NCSNv2_128(_RefineNet):
    """The 96-128px NCSNv2 (JAX ``ncsnv2.py:308``): five levels, channel
    multiples (1, 2, 2, 4, 4), dilations at the last two."""
    LEVELS = (("1", 1, 1, False), ("2", 2, 1, True), ("3", 2, 1, True),
              ("4", 4, 2, True), ("5", 4, 4, True))
    REFINES = (("1", 4), ("2", 2), ("3", 2), ("4", 1), ("5", 1))


class NCSNv2_256(_RefineNet):
    """The 128-256px NCSNv2 (JAX ``ncsnv2.py:354``): six levels (``res31``
    inserted) and ``refine31`` fused in that order."""
    LEVELS = (("1", 1, 1, False), ("2", 2, 1, True), ("3", 2, 1, True),
              ("31", 2, 1, True), ("4", 4, 2, True), ("5", 4, 4, True))
    REFINES = (("1", 4), ("2", 2), ("31", 2), ("3", 2), ("4", 1), ("5", 1))


class NCSN(_RefineNet):
    """NCSN v1 (JAX ``ncsnv2.py:585``): NCSNv2's walk with every norm
    conditional on the label (``num_scales`` classes); the output is not
    divided by sigma."""
    LEVELS = NCSNv2.LEVELS
    REFINES = NCSNv2.REFINES
    conditional = True


def get_network(image_size: int):
    """The NCSNv2 for an image size (JAX ``ncsnv2.py:404``)."""
    if image_size < 96:
        return NCSNv2
    if image_size <= 128:
        return NCSNv2_128
    if image_size <= 256:
        return NCSNv2_256
    raise NotImplementedError(image_size)


def ncsnv2_torch_path_map(path: tuple[str, ...]) -> str:
    """A port module path -> the reference's torch key prefix, as JAX's
    ``ncsnv2_torch_path_map``: ``res1_0`` -> ``res1.0``, ``adapt_convs_0``
    -> ``adapt_convs.0``, ``bI_J_conv`` -> ``I_J_conv`` (and ``_norm``),
    ``convs_i`` / ``norms_i`` -> ``convs.i`` / ``norms.i``; ConvMeanPool's
    inner ``conv`` stays."""
    parts = []
    for seg in path:
        if seg.startswith("res") and "_" in seg:
            parts.extend(seg.split("_"))
        elif seg.startswith(("adapt_convs_", "convs_", "norms_")):
            head, i = seg.rsplit("_", 1)
            parts.extend([head, i])
        elif (seg.startswith("b") and seg[1].isdigit()
              and seg.endswith(("_conv", "_norm"))):
            parts.append(seg[1:])
        else:
            parts.append(seg)
    return ".".join(parts)
