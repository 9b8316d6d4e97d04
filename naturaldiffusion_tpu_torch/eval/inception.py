"""InceptionV3 of pytorch-fid, NHWC, in PyTorch: the FID feature extractor
(port of ``naturaldiffusion_tpu/eval/inception.py``).

pytorch-fid's ``InceptionV3`` (used by the reference at
``src/CIFAR10NaturalInference.py:44-70``) with its deviations from
torchvision: avg-pool branches with ``count_include_pad=False``
(FIDInceptionA/C/E_1) and a MAX-pool branch in the last block
(FIDInceptionE_2).  The module and parameter names are the JAX package's
(``Conv2d_1a_3x3.conv.kernel`` ``[kh, kw, I, O]``, ``….bn.{scale, bias,
mean, var}``, ``Mixed_5b`` … ``Mixed_7c``, ``fc.{kernel, bias}``), so
:func:`..models.convert.load_jax_params` carries a flax tree across and
:func:`convert_fid_inception_state` fills it from
``pt_inception-2015-12-05.pth``.

Inference only: BatchNorm is a frozen affine ``(x - mean) / sqrt(var +
1e-3) * scale + bias``.  Input ``[N, H, W, 3]`` in [0, 1], resized to 299²
bilinear with half-pixel centres (antialiased when the image is larger than
299 in a dimension, as ``jax.image.resize`` is) and scaled to [-1, 1];
output the 2048-d final average pool, and with ``with_logits`` also the
1008 logits of the IS head.  The convolutions and pools are PyTorch's
(``F.conv2d``, ``F.max_pool2d``, ``F.avg_pool2d``), as the JAX package's are
XLA's: no hand-written kernel stands behind them.  Tensors stay NHWC; each
conv and pool sees a permuted view of them (channels-last memory).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class BN(nn.Module):
    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = _frozen(torch.ones(c))
        self.bias = _frozen(torch.zeros(c))
        self.mean = _frozen(torch.zeros(c))
        self.var = _frozen(torch.ones(c))

    def forward(self, x):
        return ((x - self.mean) * torch.rsqrt(self.var + self.eps)
                * self.scale + self.bias)


class Conv(nn.Module):
    """A bias-free conv, kernel ``[kh, kw, I, O]``; ``padding`` (ph, pw)
    zeros on both sides of each dimension."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.kernel = _frozen(torch.zeros(tuple(kernel) + (cin, cout)))
        self.stride, self.padding = stride, tuple(padding)

    def forward(self, x):
        w = self.kernel.permute(3, 2, 0, 1)
        return _nhwc(F.conv2d(_nchw(x), w, stride=self.stride,
                              padding=self.padding))


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, padding)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_nocount(x):
    """3x3 average pool, stride 1, pad 1, ``count_include_pad=False`` (the
    pytorch-fid quirk)."""
    return _nhwc(F.avg_pool2d(_nchw(x), 3, 1, 1, count_include_pad=False))


def resize_299(x):
    """``[N, H, W, C]`` -> ``[N, 299, 299, C]``, bilinear with half-pixel
    centres, as ``jax.image.resize(..., "bilinear")``: that antialiases
    where it shrinks a dimension, so this does where H or W is over 299."""
    h, w = x.shape[1:3]
    return _nhwc(F.interpolate(_nchw(x), size=(299, 299), mode="bilinear",
                               align_corners=False,
                               antialias=h > 299 or w > 299))


def max_pool(x, stride: int = 2, pad: int = 0):
    """3x3 max pool: VALID with stride 2 (every block's), or stride 1 pad 1
    (``Mixed_7c``'s pool branch)."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, stride, pad))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))
        self.cout = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_nocount(x))
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)
        self.cout = 384 + 96 + cin

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x)], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))
        self.cout = 4 * 192

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(avg_pool_nocount(x))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)
        self.cout = 320 + 192 + cin

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, max_pool(x)], dim=-1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str = "avg"):
        super().__init__()
        self.pool_kind = pool_kind   # FIDInceptionE_1: avg; E_2: max
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))
        self.cout = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=-1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=-1)
        if self.pool_kind == "avg":
            bp = avg_pool_nocount(x)
        else:   # FIDInceptionE_2: pytorch-fid's deliberate max pool
            bp = max_pool(x, stride=1, pad=1)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=-1)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = _frozen(torch.zeros(cin, cout))
        self.bias = _frozen(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class FIDInceptionV3(nn.Module):
    """``forward(x [N, H, W, 3] in [0, 1])`` -> pool ``[N, 2048]``, or
    ``(pool, logits [N, 1008])`` with ``with_logits``.  The parameters are
    zeros and ones until loaded (:func:`default_feature_fn`,
    :func:`convert_fid_inception_state`, ``load_jax_params``)."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True, with_logits: bool = False):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.with_logits = with_logits
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        blocks = {}
        c = 192
        for name, make in (("Mixed_5b", lambda c: InceptionA(c, 32)),
                           ("Mixed_5c", lambda c: InceptionA(c, 64)),
                           ("Mixed_5d", lambda c: InceptionA(c, 64)),
                           ("Mixed_6a", InceptionB),
                           ("Mixed_6b", lambda c: InceptionC(c, 128)),
                           ("Mixed_6c", lambda c: InceptionC(c, 160)),
                           ("Mixed_6d", lambda c: InceptionC(c, 160)),
                           ("Mixed_6e", lambda c: InceptionC(c, 192)),
                           ("Mixed_7a", InceptionD),
                           ("Mixed_7b", lambda c: InceptionE(c, "avg")),
                           ("Mixed_7c", lambda c: InceptionE(c, "max"))):
            blocks[name] = make(c)
            c = blocks[name].cout
        for name, block in blocks.items():
            self.add_module(name, block)
        self.blocks = tuple(blocks)
        if with_logits:
            self.fc = Dense(2048, 1008)

    def forward(self, x):
        if self.resize_input:
            x = resize_299(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = max_pool(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = max_pool(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        pool = x.mean(dim=(1, 2))   # global average pool -> [N, 2048]
        if self.with_logits:
            return pool, self.fc(pool)
        return pool


def randomize_inception_(model: FIDInceptionV3, seed: int) -> FIDInceptionV3:
    """Random weights from ``seed``, in place, on the CPU generator: conv
    and dense kernels from flax's default ``lecun_normal`` distribution (a
    normal of variance 1/fan_in truncated at two standard deviations),
    dense bias zero, BatchNorm flax's identity (scale 1, bias 0, mean 0,
    var 1).  Returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                v = nn.init.trunc_normal_(torch.empty(p.shape), std=std,
                                          a=-2 * std, b=2 * std, generator=g)
            else:
                v = (torch.ones if leaf in ("scale", "var")
                     else torch.zeros)(p.shape)
            p.copy_(v)
    return model


def convert_fid_inception_state(sd, template: FIDInceptionV3 | None = None):
    """Fill ``template`` (default a new ``FIDInceptionV3()`` on the CPU)
    from a pytorch-fid / torchvision inception ``state_dict`` (flat name ->
    array).  BatchNorm leaves: scale <- weight, bias <- bias, mean <-
    running_mean, var <- running_var; ``AuxLogits.*`` and
    ``num_batches_tracked`` are dropped, and the 1008-way ``fc`` is kept
    only when the template has one (``with_logits``, the IS path).
    Returns ``(template, unused torch keys)``."""
    from ..models.convert import fill_from_torch

    if template is None:
        template = FIDInceptionV3()
    keep_fc = template.with_logits
    sd = {k: v for k, v in sd.items()
          if not k.startswith("AuxLogits.")
          and (keep_fc or not k.startswith("fc."))
          and "num_batches_tracked" not in k}
    renamed = {k.replace(".running_mean", ".mean")
               .replace(".running_var", ".var"): v for k, v in sd.items()}
    unused = fill_from_torch(template, renamed, path_map=".".join)
    return template, unused


def load_fid_inception_params(pth_path: str,
                              template: FIDInceptionV3 | None = None):
    """:func:`convert_fid_inception_state` of pytorch-fid's
    ``pt_inception-2015-12-05.pth``."""
    from ..models.convert import load_torch_checkpoint
    return convert_fid_inception_state(load_torch_checkpoint(pth_path),
                                       template=template)


def default_feature_fn(pth_path: str | None = None, with_logits: bool = False,
                       device="cuda", seed: int = 0):
    """``fn(images [N, H, W, 3] in [0, 1]) -> [N, 2048]`` float32 on
    ``device`` (default ``"cuda"``, which raises without a card; any input
    tensor or array is moved there).  With ``with_logits`` the 1008 IS
    logits follow the pool features: ``[N, 2048 + 1008]``, one pass for
    both FID and IS, as the reference computes them
    (``deps/score_sde_pytorch/run_lib.py:175-407``).

    Weights: converted from ``pth_path`` (``pt_inception-2015-12-05.pth``)
    when given, else random from ``seed`` (:func:`randomize_inception_`),
    which serves the pipeline and the estimator checks, not a real FID.
    The random weights follow flax's init distribution but cannot equal the
    JAX package's ``PRNGKey(0)`` draw."""
    dev = resolve_device(device)
    model = FIDInceptionV3(with_logits=with_logits)
    if pth_path:
        load_fid_inception_params(pth_path, template=model)
    else:
        randomize_inception_(model, seed)
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(images):
        out = model(torch.as_tensor(images, dtype=torch.float32).to(dev))
        if with_logits:
            return torch.cat(out, dim=-1)
        return out

    fn.model = model
    return fn
