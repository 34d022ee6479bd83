"""Building-block layers of the U-Net, eval mode, NCHW.

Counterparts of ``unet_tpu/models/layers.py`` for the tpu_opt topology:
ConvLayer (conv → [BatchNorm] → [ReLU] with torch-style symmetric
padding), the Bag-of-Tricks ResBlock, the k2-s2 transposed-conv upsample,
and the space/depth permutations. Parameters stay float32; each conv runs
in the dtype of its input (bf16 on the card, float32 in the tests), as
flax's ``dtype=`` does. Attribute names match the flax module names so a
state_dict key maps one to one onto a flax parameter path
(``train/checkpoint.py``).

Training-mode BatchNorm (flax momentum 0.9 = torch 0.1, biased running
variance) comes with the training slice; in train mode BatchNorm raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def torch_pad(ks: int) -> int:
    """Symmetric padding of torch ``Conv2d(padding=ks//2)`` (odd ks)."""
    return (ks - 1) // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (float32 weights are
    cast on the fly, as flax casts ``param_dtype`` to ``dtype``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding)


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm with running statistics, in flax's order: the
    float32 running stats promote the normalize to float32
    (``(x - mean) * (rsqrt(var + eps) * scale) + bias``) and the result is
    cast back to ``x.dtype``."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * weight
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` parameters (scale/bias → weight/bias, mean/var
    → running_mean/running_var), eval mode only."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm: later slice (call .eval())")
        return batch_norm(x, self.running_mean, self.running_var,
                          self.weight, self.bias, self.eps)


class ConvLayer(nn.Module):
    """conv → [BatchNorm] → [ReLU] (fastai ConvLayer). ``norm``: None |
    'batch' | 'batchzero'; bias exactly when there is no norm."""

    def __init__(self, ni: int, nf: int, ks: int = 3, stride: int = 1,
                 norm: Optional[str] = "batch", act: bool = True,
                 pad: Optional[int] = None):
        super().__init__()
        self.norm_kind = norm
        self.conv = Conv2d(ni, nf, ks, stride,
                           padding=torch_pad(ks) if pad is None else pad,
                           bias=norm is None)
        self.bn = BatchNorm(nf) if norm is not None else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


def max_pool_torch(x: torch.Tensor, ks: int = 3, stride: int = 2) -> torch.Tensor:
    """torch MaxPool2d(ks, stride, padding=ks//2)."""
    return F.max_pool2d(x, ks, stride, torch_pad(ks))


def avg_pool_ceil(x: torch.Tensor, ks: int = 2) -> torch.Tensor:
    """AvgPool2d(ks, ceil_mode=True): clipped edge windows divide by the
    number of elements they hold."""
    return F.avg_pool2d(x, ks, ks, ceil_mode=True)


class ResBlock(nn.Module):
    """fastai Bag-of-Tricks ResBlock. Expansion 1: 3x3(stride) →
    3x3(BatchZero); expansion 4: 1x1 → 3x3(stride) → 1x1(BatchZero).
    Identity path: AvgPool(2, ceil) when striding, THEN a 1x1 conv when the
    channel counts differ. ReLU after the add."""

    def __init__(self, expansion: int, ni: int, nf: int, stride: int = 1):
        super().__init__()
        nf_out = nf * expansion
        self.expansion, self.stride = expansion, stride
        if expansion == 1:
            self.conv1 = ConvLayer(ni, nf, 3, stride)
            self.conv2 = ConvLayer(nf, nf_out, 3, 1, norm="batchzero", act=False)
            self.conv3 = None
        else:
            self.conv1 = ConvLayer(ni, nf, 1, 1)
            self.conv2 = ConvLayer(nf, nf, 3, stride)
            self.conv3 = ConvLayer(nf, nf_out, 1, 1, norm="batchzero", act=False)
        self.idconv = (ConvLayer(ni, nf_out, 1, 1, act=False)
                       if ni != nf_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.conv3 is not None:
            y = self.conv3(y)
        idn = avg_pool_ceil(x, 2) if self.stride != 1 else x
        if self.idconv is not None:
            idn = self.idconv(idn)
        return F.relu(y + idn)


class ConvTransposeUp(nn.Module):
    """2x upsample as a k2-s2 transposed conv, then ReLU."""

    def __init__(self, ni: int, nf: int):
        super().__init__()
        self.convt = ConvTranspose2d(ni, nf, 2, 2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convt(x))


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B,C,H,W) → (B,C·r²,H/r,W/r) with (dy, dx, c) channel order (the
    JAX package's order; ``F.pixel_unshuffle`` uses (c, dy, dx))."""
    b, c, h, w = x.shape
    x = x.view(b, c, h // r, r, w // r, r)       # B, c, h, dy, w, dx
    x = x.permute(0, 3, 5, 1, 2, 4)              # B, dy, dx, c, h, w
    return x.reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth``: (B,r²·c,h,w) with (dy, dx, c) channel
    order → (B,c,h·r,w·r)."""
    b, rrc, h, w = x.shape
    c = rrc // (r * r)
    x = x.view(b, r, r, c, h, w)                 # B, dy, dx, c, h, w
    x = x.permute(0, 3, 4, 1, 5, 2)              # B, c, h, dy, w, dx
    return x.reshape(b, c, h * r, w * r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """torch PixelShuffle: (c, dy, dx) channel order."""
    return F.pixel_shuffle(x, r)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(method='nearest')`` over H and W: source index
    floor((i + 0.5) · in / out), computed in float32."""
    for dim, n in ((2, size[0]), (3, size[1])):
        m = x.shape[dim]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).floor()
        x = x.index_select(dim, idx.long().clamp_(max=m - 1).to(x.device))
    return x
