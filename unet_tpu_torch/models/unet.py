"""The U-Net over an XResNet body, NCHW, in both topologies.

Counterpart of ``unet_tpu/models/unet.py``'s ``DynamicUnet``. Widths are
derived statically from the architecture table, as the JAX package does.

* tpu_opt (the default): folded stem, k2-s2 transposed-conv upsampling,
  the slim decoder width rule, a single-conv final block, and the half-res
  tail (concat with space-to-depth of the input → ResBlock without norm →
  1x1 sub-pixel head to ``n_out·4``).
* parity (``tpu_opt=False``), the reference's fastai DynamicUnet with its
  ``blur=True, blur_final=True``: the three-conv stem, PixelShuffle-ICNR
  upsampling with the replication blur in every block, ``up_nf = up_c //
  2`` and ``nf = cat`` (``cat // 2`` in the final block), then a trailing
  PixelShuffle-ICNR without blur back to full resolution, the
  nearest-resize to the input grid, the full-resolution last_cross
  ResBlock on ``cat(y, x)`` and a 1x1 head to ``n_out``.

``self_attention`` puts a SelfAttention after the second conv of decoder
block ``n − 3`` in either topology.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm, Conv2d, ConvLayer, ConvTransposeUp,
                     ConvTranspose2d, PixelShuffleICNR, SelfAttention,
                     pixel_shuffle, resize_nearest, space_to_depth)
from .xresnet import ARCHS, XResNetBody, stage_out_channels

# equal to unet_tpu/models/unet.py TPU_OPT_TOPOLOGY_VERSION: bundles record
# it, and a mismatch means the parameter shapes differ
TPU_OPT_TOPOLOGY_VERSION = 3


class UnetBlock(nn.Module):
    """One decoder stage: upsample (a transposed conv under tpu_opt, else
    PixelShuffle-ICNR with optional blur), fuse the BatchNorm'd skip,
    refine, and optionally attend."""

    def __init__(self, up_c: int, skip_c: int, up_nf: int, nf_out: int,
                 single_conv: bool = False, norm: Optional[str] = None,
                 convt_up: bool = True, blur: bool = False,
                 self_attention: bool = False):
        super().__init__()
        self.shuf = (ConvTransposeUp(up_c, up_nf) if convt_up
                     else PixelShuffleICNR(up_c, up_nf, blur=blur))
        self.bn = BatchNorm(skip_c)
        self.conv1 = ConvLayer(up_nf + skip_c, nf_out, 3, norm=norm)
        self.conv2 = None if single_conv else ConvLayer(nf_out, nf_out, 3, norm=norm)
        self.sa = SelfAttention(nf_out) if self_attention else None

    def forward(self, up_in: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up_out = self.shuf(up_in)
        if up_out.shape[2:] != skip.shape[2:]:
            # odd encoder sizes: nearest-resize to the skip grid
            up_out = resize_nearest(up_out, skip.shape[2:])
        s = self.bn(skip.to(up_out.dtype))
        x = self.conv1(F.relu(torch.cat([up_out, s], dim=1)))
        if self.conv2 is not None:
            x = self.conv2(x)
        return x if self.sa is None else self.sa(x)


class ResBlockNoNorm(nn.Module):
    """The last_cross ResBlock (expansion 1, stride 1) with the decoder's
    norm setting (None: conv bias, no BatchNorm)."""

    def __init__(self, ni: int, nf: int, norm: Optional[str] = None):
        super().__init__()
        self.conv1 = ConvLayer(ni, nf, 3, norm=norm)
        second = "batchzero" if norm == "batch" else norm
        self.conv2 = ConvLayer(nf, nf, 3, norm=second, act=False)
        self.idconv = (ConvLayer(ni, nf, 1, act=False, norm=norm)
                       if ni != nf else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        idn = x if self.idconv is None else self.idconv(x)
        return F.relu(y + idn)


def decoder_widths(skip_channels: List[int], feat_c: int, c_in: int,
                   tpu_opt: bool = True):
    """(up_c, skip_c, up_nf, nf_out) per decoder block.

    tpu_opt: each upsample is sized so its concat with the skip lands on a
    multiple of 128 channels; the final block takes 128 − 4·c_in so the
    tail's space-to-depth concat is exactly 128. Parity (fastai): the
    upsample halves the channels and nf is the concat's width, halved in
    the final block (512 → 384 → 256 → 96 for xresnet34)."""
    out = []
    y_c = feat_c
    n = len(skip_channels)
    for i, skip_c in enumerate(skip_channels):
        if tpu_opt:
            rem = skip_c % 128
            up_nf = min(128 - rem if rem else 128, y_c // 2)
            nf_out = max(128 - 4 * c_in, 64) if i == n - 1 else skip_c + up_nf
        else:
            up_nf = y_c // 2
            nf_out = (up_nf + skip_c) // (2 if i == n - 1 else 1)
        out.append((y_c, skip_c, up_nf, nf_out))
        y_c = nf_out
    return out


class DynamicUnet(nn.Module):
    """U-Net over an XResNet body. ``forward`` returns float32 logits (B,
    n_out, H, W). Under tpu_opt, ``fold_logits=True`` returns the sub-pixel
    head's pre-shuffle logits (B, n_out·4, H/2, W/2) in (class, dy, dx)
    channel order (the training loss takes these); the parity topology
    ignores ``fold_logits`` and always returns full-resolution logits, as
    the JAX package does (callers compare shapes). In training mode every
    BatchNorm normalizes with its batch statistics and every SelfAttention
    advances its power iteration."""

    def __init__(self, arch: str = "xresnet34", n_out: int = 2, c_in: int = 3,
                 self_attention: bool = False, last_cross: bool = True,
                 bottle: bool = False, decoder_norm: Optional[str] = None,
                 tpu_opt: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch, self.n_out, self.c_in = arch, n_out, c_in
        self.tpu_opt = tpu_opt
        self.dtype = dtype
        self.encoder = XResNetBody(arch, c_in, tpu_opt=tpu_opt)
        stages = stage_out_channels(arch)
        ni = stages[-1]
        self.mid_bn = BatchNorm(ni)
        self.mid_conv1 = ConvLayer(ni, ni * 2, 3, norm=decoder_norm)
        self.mid_conv2 = ConvLayer(ni * 2, ni, 3, norm=decoder_norm)
        skip_channels = list(reversed(stages[:-1])) + [64]
        widths = decoder_widths(skip_channels, ni, c_in, tpu_opt)
        n = self.n_up = len(widths)
        for i, (up_c, skip_c, up_nf, nf_out) in enumerate(widths):
            self.add_module(f"up_{i}", UnetBlock(
                up_c, skip_c, up_nf, nf_out, single_conv=tpu_opt and i == n - 1,
                norm=decoder_norm, convt_up=tpu_opt, blur=not tpu_opt,
                self_attention=self_attention and i == n - 3))
        y_c = widths[-1][3]
        # parity: the decoder ends at the stem's /2, so one more shuffle
        # (fastai appends PixelShuffle_ICNR without blur) back to full res
        self.final_shuf = None if tpu_opt else PixelShuffleICNR(y_c, y_c)
        merged = c_in * (4 if tpu_opt else 1)  # s2d(x) at /2, or x itself
        self.last_cross = None
        if last_cross:
            ni_rb = y_c + merged
            self.last_cross = ResBlockNoNorm(
                ni_rb, ni_rb // 2 if bottle else ni_rb, norm=decoder_norm)
            y_c = ni_rb // 2 if bottle else ni_rb
        self.head = Conv2d(y_c, n_out * (4 if tpu_opt else 1), 1, bias=True)

    def forward(self, x: torch.Tensor, fold_logits: bool = False) -> torch.Tensor:
        orig = x.to(self.dtype)
        feats, skips = self.encoder(orig)
        y = F.relu(self.mid_bn(feats))
        y = self.mid_conv2(self.mid_conv1(y))
        for i, skip in enumerate(skips):
            y = getattr(self, f"up_{i}")(y, skip)
        if self.tpu_opt:
            if y.shape[2] * 2 != orig.shape[2]:
                raise AssertionError((tuple(y.shape), tuple(orig.shape)))
            if self.last_cross is not None:
                y = self.last_cross(torch.cat([y, space_to_depth(orig, 2)], dim=1))
            sub = self.head(y)
            if fold_logits:
                return sub.float()
            return pixel_shuffle(sub, 2).float()
        if y.shape[2:] != orig.shape[2:]:
            y = self.final_shuf(y)
        if y.shape[2:] != orig.shape[2:]:
            y = resize_nearest(y, orig.shape[2:])  # odd input sides
        if self.last_cross is not None:
            y = self.last_cross(torch.cat([y, orig], dim=1))
        return self.head(y).float()


def build_unet(arch: str = "xresnet34", n_out: int = 2, c_in: int = 3,
               self_attention: bool = False,
               dtype: torch.dtype = torch.bfloat16, **kwargs) -> DynamicUnet:
    """The eval-mode U-Net (``tpu_opt`` defaults to True here;
    ``tpu_opt=False`` builds the parity topology)."""
    if arch not in ARCHS:
        raise ValueError(f"Unknown architecture {arch!r}; options: {sorted(ARCHS)}")
    return DynamicUnet(arch=arch, n_out=n_out, c_in=c_in,
                       self_attention=self_attention, dtype=dtype,
                       **kwargs).eval()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator``, after the JAX package's initializers:
    He-normal conv kernels (fan in), ICNR-equal taps for the transposed
    convs and the PixelShuffle-ICNR convs (the four sub-kernels of each
    output channel equal), zero biases, BatchNorm scale 1 (0 for
    BatchZero), running stats 0/1, lecun-normal SelfAttention kernels, γ =
    0 and unit-norm normal u vectors. Every parameter and buffer is set, so
    a trained model re-initialized equals a new one. For smoke runs and
    tests; trained weights come from a bundle."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for mod in model.modules():
        if isinstance(mod, ConvTranspose2d):
            ni, nf = mod.weight.shape[:2]
            w = torch.randn(ni, nf, 1, 1, generator=generator) * math.sqrt(2.0 / ni)
            mod.weight.copy_(w.expand_as(mod.weight))
            mod.bias.zero_()
        elif isinstance(mod, Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                             * math.sqrt(2.0 / fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, ConvLayer) and mod.bn is not None:
            mod.bn.weight.fill_(0.0 if mod.norm_kind == "batchzero" else 1.0)
        elif isinstance(mod, SelfAttention):
            for name in ("query", "key", "value"):
                k = getattr(mod, f"{name}_kernel")
                k.copy_(torch.randn(k.shape, generator=generator) / math.sqrt(k.shape[0]))
                u = torch.randn(k.shape[1], generator=generator)
                getattr(mod, f"{name}_u").copy_(u / u.norm())
            mod.gamma.zero_()
    for mod in model.modules():
        if isinstance(mod, PixelShuffleICNR):
            w = mod.conv.weight  # (4·nf, ni, 1, 1), channel f·4 + phase
            ni = w.shape[1]
            k = torch.randn(w.shape[0] // 4, ni, 1, 1, generator=generator) * math.sqrt(2.0 / ni)
            w.copy_(k.repeat_interleave(4, dim=0))
    return model
