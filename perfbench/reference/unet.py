"""Plain PyTorch reference of the two U-Net topologies the benchmark runs.

A frozen copy of the mathematics, written for clarity and float32: fastai's
DynamicUnet over an XResNet body in its parity form (three-conv stem,
PixelShuffle-ICNR upsampling with the replication blur, the trailing
shuffle, last_cross, an optional self-attention) and the tpu_opt form
(folded 4x4/4 stem, k2-s2 transposed-conv upsampling, the slim decoder
widths, the half-resolution tail and a sub-pixel head). Parameter and
buffer names equal the measured program's, so one state dict loads into
both; nothing here imports the program.

Training-mode BatchNorm uses the batch's mean and biased variance and
moves its running averages with momentum 0.9; eval mode uses the running
statistics. ``calibrate=True`` on a model in training mode copies each
site's batch statistics into its running buffers instead (the benchmark's
stand-in for trained statistics when it serves random weights).

``quant`` is None (float32) or ``"fp8"``: every convolution and matrix
product then takes its operands through float8 e4m3 with one scale per
tensor (straight-through in the backward). That is the lower-precision
control of the comparison that decides ``correct``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at one scale for the tensor (its largest
    magnitude maps to 448), back in ``x``'s dtype; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


class Precision:
    """The operand rounding of every product: none, or ``fp8``."""

    def __init__(self, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.quant = quant

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.quant is None else fp8_round(x)


class Conv(nn.Module):
    """Convolution with torch's symmetric padding (``pad`` overrides)."""

    def __init__(self, prec: Precision, ni: int, nf: int, ks: int, stride: int = 1,
                 pad: Optional[int] = None, bias: bool = False):
        super().__init__()
        self.prec = prec
        self.stride = stride
        self.pad = (ks - 1) // 2 if pad is None else pad
        self.weight = nn.Parameter(torch.zeros(nf, ni, ks, ks))
        self.bias = nn.Parameter(torch.zeros(nf)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self.prec(x), self.prec(self.weight), self.bias, self.stride, self.pad)


class ConvT(nn.Module):
    """k2-s2 transposed convolution with bias."""

    def __init__(self, prec: Precision, ni: int, nf: int):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.zeros(ni, nf, 2, 2))
        self.bias = nn.Parameter(torch.zeros(nf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(self.prec(x), self.prec(self.weight), self.bias, 2)


class BatchNorm(nn.Module):
    momentum = 0.9

    def __init__(self, c: int, zero: bool = False, eps: float = 1e-5):
        super().__init__()
        self.zero = zero  # the residual branch's last norm (fastai BatchZero)
        self.eps = eps
        self.calibrate = False
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                if self.calibrate:
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
                else:
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * (inv * self.weight).view(shape) + self.bias.view(shape)


class ConvLayer(nn.Module):
    """conv → [BatchNorm] → [ReLU]; a conv bias exactly when there is no norm."""

    def __init__(self, prec: Precision, ni: int, nf: int, ks: int = 3, stride: int = 1,
                 norm: Optional[str] = "batch", act: bool = True, pad: Optional[int] = None):
        super().__init__()
        self.conv = Conv(prec, ni, nf, ks, stride, pad, bias=norm is None)
        self.bn = None if norm is None else BatchNorm(nf, zero=norm == "batchzero")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class ResBlock(nn.Module):
    """Bag-of-Tricks basic block: 3x3(stride) → 3x3(BatchZero); identity
    through AvgPool(2, ceil) when striding, then a 1x1 conv + BatchNorm when
    the widths differ; ReLU after the add."""

    def __init__(self, prec: Precision, ni: int, nf: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvLayer(prec, ni, nf, 3, stride)
        self.conv2 = ConvLayer(prec, nf, nf, 3, 1, norm="batchzero", act=False)
        self.idconv = ConvLayer(prec, ni, nf, 1, 1, act=False) if ni != nf else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        idn = F.avg_pool2d(x, 2, 2, ceil_mode=True) if self.stride != 1 else x
        if self.idconv is not None:
            idn = self.idconv(idn)
        return F.relu(y + idn)


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B,C,H,W) → (B,r²C,H/r,W/r), channel order (dy, dx, c)."""
    b, c, h, w = x.shape
    x = x.view(b, c, h // r, r, w // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth``."""
    b, rrc, h, w = x.shape
    c = rrc // (r * r)
    x = x.view(b, r, r, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, h * r, w * r)


class Body(nn.Module):
    """Stem, 3x3/2 max pool and the residual stages; returns the features
    and the skips, deepest first, the stem's output last."""

    def __init__(self, prec: Precision, cfg: dict):
        super().__init__()
        c_in = cfg["bands"]
        self.tpu_opt = cfg["topology"] == "tpu_opt"
        stem = cfg["stem_widths"]
        if self.tpu_opt:  # folded: k4-s4, two 3x3 at /4, depth-to-space to stem[2] at /2
            folded = cfg["folded_stem"]
            self.stem_0 = ConvLayer(prec, c_in, folded[0], 4, 4, pad=0)
            self.stem_1 = ConvLayer(prec, folded[0], folded[1], 3)
            self.stem_2 = ConvLayer(prec, folded[1], folded[2], 3)
        else:
            self.stem_0 = ConvLayer(prec, c_in, stem[0], 3, 2)
            self.stem_1 = ConvLayer(prec, stem[0], stem[1], 3)
            self.stem_2 = ConvLayer(prec, stem[1], stem[2], 3)
        self.blocks: List[List[str]] = []
        ni = stem[2]
        for s, (n, width) in enumerate(zip(cfg["stage_blocks"], cfg["stage_widths"])):
            names = []
            for b in range(n):
                name = f"stage_{s}_block_{b}"
                self.add_module(name, ResBlock(prec, ni, width, 2 if b == 0 and s > 0 else 1))
                ni = width
                names.append(name)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor):
        x = self.stem_2(self.stem_1(self.stem_0(x)))
        stem_out = depth_to_space(x, 2) if self.tpu_opt else x
        x = F.max_pool2d(stem_out, 3, 2, 1)
        outs = []
        for names in self.blocks:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return x, list(reversed(outs[:-1])) + [stem_out]


def replication_blur(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(F.pad(x, (1, 0, 1, 0), mode="replicate"), 2, 1)


class PixelShuffleICNR(nn.Module):
    """1x1 conv with bias → PixelShuffle(2) → ReLU → [blur]."""

    def __init__(self, prec: Precision, ni: int, nf: int, blur: bool):
        super().__init__()
        self.conv = Conv(prec, ni, 4 * nf, 1, bias=True)
        self.blur = blur

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(F.pixel_shuffle(self.conv(x), 2))
        return replication_blur(y) if self.blur else y


class ConvTransposeUp(nn.Module):
    def __init__(self, prec: Precision, ni: int, nf: int):
        super().__init__()
        self.convt = ConvT(prec, ni, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convt(x))


class SelfAttention(nn.Module):
    """SAGAN self-attention with spectral-normed projections (one power
    iteration a training forward): ``γ·(softmax over the sources of g·fᵀ)·h
    + x``, no 1/√d scale."""

    eps = 1e-12

    def __init__(self, prec: Precision, c: int):
        super().__init__()
        self.prec = prec
        nq = max(c // 8, 1)
        for name, nf in (("query", nq), ("key", nq), ("value", c)):
            self.register_parameter(f"{name}_kernel", nn.Parameter(torch.zeros(c, nf)))
            self.register_buffer(f"{name}_u", torch.full((nf,), 1 / math.sqrt(nf)))
        self.gamma = nn.Parameter(torch.zeros(1))

    def _weight(self, name: str) -> torch.Tensor:
        k = getattr(self, f"{name}_kernel")
        u_buf = getattr(self, f"{name}_u")
        with torch.no_grad():
            v = k @ u_buf
            v = v / v.norm().clamp(min=self.eps)
            if self.training:
                u = v @ k
                u = u / u.norm().clamp(min=self.eps)
                u_buf.copy_(u)
            else:
                u = u_buf
        sigma = v @ k @ u
        return k / sigma.clamp(min=self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.prec
        tokens = x.flatten(2).transpose(1, 2)
        f = q(tokens) @ q(self._weight("query"))
        g = q(tokens) @ q(self._weight("key"))
        v = q(tokens) @ q(self._weight("value"))
        beta = torch.softmax(torch.bmm(q(g), q(f).transpose(1, 2)), dim=2)
        out = self.gamma * torch.bmm(q(beta), q(v)) + tokens
        return out.transpose(1, 2).reshape(b, c, h, w)


class UnetBlock(nn.Module):
    def __init__(self, prec: Precision, up_c: int, skip_c: int, up_nf: int, nf: int,
                 tpu_opt: bool, single_conv: bool, attention: bool):
        super().__init__()
        self.shuf = (ConvTransposeUp(prec, up_c, up_nf) if tpu_opt
                     else PixelShuffleICNR(prec, up_c, up_nf, blur=True))
        self.bn = BatchNorm(skip_c)
        self.conv1 = ConvLayer(prec, up_nf + skip_c, nf, 3, norm=None)
        self.conv2 = None if single_conv else ConvLayer(prec, nf, nf, 3, norm=None)
        self.sa = SelfAttention(prec, nf) if attention else None

    def forward(self, up_in: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.shuf(up_in)
        x = self.conv1(F.relu(torch.cat([up, self.bn(skip)], dim=1)))
        if self.conv2 is not None:
            x = self.conv2(x)
        return x if self.sa is None else self.sa(x)


class LastCross(nn.Module):
    """The last_cross ResBlock without norm: 3x3 (bias, ReLU) → 3x3 (bias),
    identity, ReLU."""

    def __init__(self, prec: Precision, ni: int):
        super().__init__()
        self.conv1 = ConvLayer(prec, ni, ni, 3, norm=None)
        self.conv2 = ConvLayer(prec, ni, ni, 3, norm=None, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(self.conv1(x)) + x)


def decoder_widths(cfg: dict):
    """(up_c, skip_c, up_nf, nf) of each decoder block. Parity (fastai):
    the upsample halves the channels, nf is the concat's width, halved in
    the last block. tpu_opt: each concat lands on a multiple of 128
    channels and the last block takes 128 − 4·bands."""
    tpu_opt = cfg["topology"] == "tpu_opt"
    widths = cfg["stage_widths"]
    skips = list(reversed(widths[:-1])) + [cfg["stem_widths"][2]]
    out, y = [], widths[-1]
    for i, skip in enumerate(skips):
        last = i == len(skips) - 1
        if tpu_opt:
            rem = skip % 128
            up_nf = min(128 - rem if rem else 128, y // 2)
            nf = max(128 - 4 * cfg["bands"], 64) if last else skip + up_nf
        else:
            up_nf = y // 2
            nf = (up_nf + skip) // (2 if last else 1)
        out.append((y, skip, up_nf, nf))
        y = nf
    return out


class UNet(nn.Module):
    """The U-Net a configuration file describes. ``forward`` returns float
    logits at full resolution, (B, classes, H, W); H and W are multiples of
    32 (no resize is needed at any stage)."""

    def __init__(self, cfg: dict, quant: Optional[str] = None):
        super().__init__()
        prec = Precision(quant)
        self.tpu_opt = cfg["topology"] == "tpu_opt"
        self.encoder = Body(prec, cfg)
        ni = cfg["stage_widths"][-1]
        self.mid_bn = BatchNorm(ni)
        self.mid_conv1 = ConvLayer(prec, ni, 2 * ni, 3, norm=None)
        self.mid_conv2 = ConvLayer(prec, 2 * ni, ni, 3, norm=None)
        widths = decoder_widths(cfg)
        n = len(widths)
        for i, (up_c, skip_c, up_nf, nf) in enumerate(widths):
            self.add_module(f"up_{i}", UnetBlock(
                prec, up_c, skip_c, up_nf, nf, self.tpu_opt,
                single_conv=self.tpu_opt and i == n - 1,
                attention=cfg["self_attention"] and i == n - 3))
        y = widths[-1][3]
        self.final_shuf = None if self.tpu_opt else PixelShuffleICNR(prec, y, y, blur=False)
        ni_rb = y + cfg["bands"] * (4 if self.tpu_opt else 1)
        self.last_cross = LastCross(prec, ni_rb)
        self.head = Conv(prec, ni_rb, cfg["classes"] * (4 if self.tpu_opt else 1), 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats, skips = self.encoder(x)
        y = self.mid_conv2(self.mid_conv1(F.relu(self.mid_bn(feats))))
        for i, skip in enumerate(skips):
            y = getattr(self, f"up_{i}")(y, skip)
        if self.tpu_opt:
            y = self.last_cross(torch.cat([y, space_to_depth(x, 2)], dim=1))
            return F.pixel_shuffle(self.head(y), 2)
        y = self.final_shuf(y)  # the decoder ends at /2
        return self.head(self.last_cross(torch.cat([y, x], dim=1)))

    def set_calibrate(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.calibrate = on
