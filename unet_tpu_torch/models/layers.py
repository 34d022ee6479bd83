"""Building-block layers of the U-Net, NCHW.

Counterparts of ``unet_tpu/models/layers.py``: ConvLayer (conv →
[BatchNorm] → [ReLU] with torch-style symmetric padding), the
Bag-of-Tricks ResBlock, the k2-s2 transposed-conv upsample (tpu_opt), the
PixelShuffle-ICNR upsample with fastai's replication blur (parity), the
spectral-normed SelfAttention, and the space/depth permutations.
Parameters stay float32; each conv runs in the dtype of its input (bf16 on
the card, float32 in the tests), as flax's ``dtype=`` does. Attribute
names match the flax module names so a state_dict key maps one to one onto
a flax parameter path (``train/checkpoint.py``).

Training-mode BatchNorm follows flax's (momentum 0.9, biased running
variance), not ``nn.BatchNorm2d`` (its running variance is the unbiased
one). ``batch_norm`` picks the normalization of every BatchNorm site when
the model is built, from the variant the model is built with
(``bn_variant_scope``; ``DynamicUnet``'s ``bn_variant``), by default
``UNET_TPU_BN`` as the JAX package reads it: unset, ``fused`` or
``pallas`` (``BatchNorm``), ``slice[:k]`` (``SliceBatchNorm``) or
``group[:g]`` (``GroupNormAsBN``); all three keep one parameter and buffer
tree, so bundles load across the switch (and a bundle records the variant
it was trained with, which its loader builds).

Under ``torch.utils.checkpoint`` (``remat``) a block's forward runs again
in the backward. ``recompute_context`` marks that second run: BatchNorm
then leaves its running averages alone and SelfAttention reuses the power
iteration of the first run, so the statistics and vectors move once a
step, as flax's lifted ``nn.remat`` writes its variables once.

Under a ``parallel.halo.space_scope`` (spatial partitioning: this rank
holds rows [s·h, (s+1)·h) of every sample) each op that mixes rows does so
across the space group, as GSPMD partitions it in JAX: a convolution or
max pool pads H with its neighbours' rows (``halo.exchange``) and runs
with H padding 0, the blur replicates the global top row only, the
attention takes its sources' rows from every rank, GroupNorm sums each
sample over the group and training BatchNorm counts every rank's rows (its
group is then the world). 1×1 convolutions, the 4×4/4 stem, the k2-s2
transposed convolutions and the space/depth permutations stay local;
``resize_nearest`` raises there (tile heights divisible by 32·S never
reach it).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import re
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn import KERNEL_REDUCTIONS, BatchNormTrain
from ..parallel import halo

BN_ENV = "UNET_TPU_BN"
_state = threading.local()


def recomputing() -> bool:
    """True inside a checkpointed block's second forward (the backward's
    recompute)."""
    return getattr(_state, "recompute", False)


@contextlib.contextmanager
def _recompute():
    _state.recompute = True
    try:
        yield
    finally:
        _state.recompute = False


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: nothing around the
    first forward, ``recomputing()`` true around the recompute."""
    return contextlib.nullcontext(), _recompute()


def torch_pad(ks: int) -> int:
    """Symmetric padding of torch ``Conv2d(padding=ks//2)`` (odd ks)."""
    return (ks - 1) // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (float32 weights are
    cast on the fly, as flax casts ``param_dtype`` to ``dtype``). Under a
    space scope H is padded with the neighbours' halo rows instead."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        padding = self.padding
        if halo.current() is not None:
            top, bottom = halo.conv_halo(self.kernel_size[0], self.stride[0], padding[0])
            x, padding = halo.exchange(x, top, bottom, "zeros"), (0, padding[1])
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding)


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
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
    → running_mean/running_var).

    Training mode normalizes with the batch statistics through
    ``ops.bn.BatchNormTrain`` (the ``bn_stats`` CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors; ``reductions =
    PLAIN_REDUCTIONS`` runs the plain versions on the card too) and updates
    the running averages as flax does: ``ra = m·ra + (1 − m)·batch`` with
    momentum m = 0.9 and the biased batch variance, once a step (not in a
    recompute). ``group`` (None, or a process group set by
    ``sync_batch_norm``) makes the statistics those of the ranks' global
    batch."""

    momentum = 0.9
    n_stat: Optional[int] = None  # statistics from the whole batch

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.reductions = KERNEL_REDUCTIONS
        self.group = None
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm_eval(x, self.running_mean, self.running_var,
                                   self.weight, self.bias, self.eps)
        scope = halo.current()
        y, mean, var = BatchNormTrain.apply(x, self.weight, self.bias, self.eps,
                                            self.reductions, self.group, self.n_stat,
                                            1 if scope is None else scope.size)
        if not recomputing():
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


class SliceBatchNorm(BatchNorm):
    """``UNET_TPU_BN=slice[:k]`` (JAX's ``SliceStatsBatchNorm``): training
    statistics, and the running averages they feed, from the first
    min(k, N) samples of the batch (of the global batch under a process
    group); the normalize, eval mode and the tree are ``BatchNorm``'s."""

    def __init__(self, c: int, n_stat: int = 8, eps: float = 1e-5):
        super().__init__(c, eps)
        self.n_stat = int(n_stat)


class GroupNormAsBN(BatchNorm):
    """``UNET_TPU_BN=group[:g]`` (JAX's ``GroupNormAsBN``): GroupNorm over
    the largest divisor of C that is <= ``groups``, per sample, in training
    and eval alike, behind BatchNorm's tree (the running buffers are kept
    and never read or written). Statistics in float32; the normalized
    values are cast to the input's dtype before the scale and bias, as
    JAX orders it. No cross-sample reduction, so no ``bn_stats`` kernel:
    plain PyTorch, as JAX computes it outside any Pallas kernel. Under a
    space scope each sample's sums run over the group's rows."""

    def __init__(self, c: int, groups: int = 32, eps: float = 1e-5):
        super().__init__(c, eps)
        self.groups = max(d for d in range(1, min(int(groups), c) + 1) if c % d == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xg = x.reshape(n, self.groups, c // self.groups, h, w).float()
        scope = halo.current()
        if scope is None:
            mean = xg.mean(dim=(2, 3, 4), keepdim=True)
            mean_sq = (xg * xg).mean(dim=(2, 3, 4), keepdim=True)
        else:
            count = xg[0, 0].numel() * scope.size
            sums = halo.all_reduce(torch.stack([xg.sum(dim=(2, 3, 4), keepdim=True),
                                                (xg * xg).sum(dim=(2, 3, 4), keepdim=True)]))
            mean, mean_sq = sums[0] / count, sums[1] / count
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(n, c, h, w).to(x.dtype)
        shape = (1, -1, 1, 1)
        return y * self.weight.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


_VARIANT = re.compile(r"(slice|group)(?::(\d+))?")
FROM_ENV = "from-env"  # bn_variant default: UNET_TPU_BN when the model is built
_building: contextvars.ContextVar = contextvars.ContextVar("bn_variant", default=FROM_ENV)


def parse_bn_variant(value: Optional[str], what: str = BN_ENV) -> Optional[str]:
    """The normalized BatchNorm variant of ``value`` (an ``UNET_TPU_BN``
    value, or one a bundle records): None for unset, empty, ``fused`` or
    ``pallas`` (each builds ``BatchNorm``), else ``slice:k`` or
    ``group:g`` with the default k = 8, g = 32 filled in. Any other value
    raises ``ValueError`` naming ``what``."""
    if value in (None, "", "fused", "pallas"):
        return None
    m = _VARIANT.fullmatch(value)
    if m is None or m.group(2) == "0":
        raise ValueError(f"{what}={value!r}: expected fused, pallas, slice[:k] "
                         "or group[:g] with k, g >= 1")
    return f"{m.group(1)}:{int(m.group(2) or (8 if m.group(1) == 'slice' else 32))}"


def env_bn_variant() -> Optional[str]:
    """``UNET_TPU_BN`` as it is set now, normalized (``parse_bn_variant``)."""
    return parse_bn_variant(os.environ.get(BN_ENV, ""))


def env_differs(variant: Optional[str]) -> bool:
    """True when ``UNET_TPU_BN`` as it is set now is not the normalized
    ``variant``, or is no valid value."""
    try:
        return env_bn_variant() != variant
    except ValueError:
        return True


@contextlib.contextmanager
def bn_variant_scope(variant: Optional[str]):
    """Every ``batch_norm`` site built inside the block takes ``variant``
    (normalized; None is ``BatchNorm``) instead of reading the
    environment."""
    token = _building.set(variant)
    try:
        yield
    finally:
        _building.reset(token)


def batch_norm(c: int, eps: float = 1e-5) -> BatchNorm:
    """The BatchNorm of one site, of the variant the enclosing
    ``bn_variant_scope`` gives, else of ``UNET_TPU_BN`` as it is set now
    (the JAX package's ``batch_norm`` factory): unset, ``fused`` or
    ``pallas`` give ``BatchNorm`` (its ``bn_sum_sumsq`` is the one-pass
    (Σx, Σx²) reduction both JAX variants compute), ``slice[:k]`` a
    ``SliceBatchNorm`` (k = 8 by default), ``group[:g]`` a
    ``GroupNormAsBN`` (g = 32 by default). Any other value raises
    ``ValueError``."""
    variant = _building.get()
    if variant == FROM_ENV:
        variant = env_bn_variant()
    if variant is None:
        return BatchNorm(c, eps)
    kind, n = variant.split(":")
    if kind == "slice":
        return SliceBatchNorm(c, int(n), eps)
    return GroupNormAsBN(c, int(n), eps)


def sync_batch_norm(model: nn.Module, group) -> None:
    """Set the process group of every ``BatchNorm`` in ``model`` (None:
    each process's own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
        self.bn = batch_norm(nf) if norm is not None else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


def max_pool_torch(x: torch.Tensor, ks: int = 3, stride: int = 2) -> torch.Tensor:
    """torch MaxPool2d(ks, stride, padding=ks//2); under a space scope the
    rows above come from the rank above (−inf above the tile)."""
    pad = torch_pad(ks)
    if halo.current() is None:
        return F.max_pool2d(x, ks, stride, pad)
    top, bottom = halo.conv_halo(ks, stride, pad)
    return F.max_pool2d(halo.exchange(x, top, bottom, "-inf"), ks, stride, (0, pad))


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
    floor((i + 0.5) · in / out), computed in float32. Not under a space
    scope (``ValueError``): a tile height divisible by 32·S never needs
    it."""
    if halo.current() is not None:
        raise ValueError(f"a nearest resize of {tuple(x.shape[2:])} to {tuple(size)} under "
                         "spatial partitioning: the tile height must be divisible by 32·S")
    for dim, n in ((2, size[0]), (3, size[1])):
        m = x.shape[dim]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).floor()
        x = x.index_select(dim, idx.long().clamp_(max=m - 1).to(x.device))
    return x


def replication_blur(x: torch.Tensor) -> torch.Tensor:
    """fastai's anti-checkerboard blur: ReplicationPad2d((1, 0, 1, 0)), then
    AvgPool2d(2, stride=1). Shape-preserving. Under a space scope the row
    above is the rank above's last (the tile's first row, replicated, at
    its top)."""
    if halo.current() is None:
        return F.avg_pool2d(F.pad(x, (1, 0, 1, 0), mode="replicate"), 2, 1)
    x = halo.exchange(x, 1, 0, "replicate")
    return F.avg_pool2d(F.pad(x, (1, 0, 0, 0), mode="replicate"), 2, 1)


class PixelShuffleICNR(nn.Module):
    """fastai PixelShuffle_ICNR with the reference's effective config: a
    1x1 conv with bias and no norm (ICNR init, ``init_weights``) →
    PixelShuffle(2) in (c, dy, dx) channel order → ReLU → [blur]. The conv
    keeps the flax parameter shapes (``conv/kernel`` (1, 1, ni, 4·nf),
    ``conv/bias`` (4·nf)).

    The JAX package computes the conv and the shuffle as one k2-s2
    transposed conv with a per-phase bias (``_ShuffleConv``), the same
    function; on the H100 the conv + shuffle is the faster of the two
    (``chip_smoke.py`` times both at the parity model's upsamples)."""

    def __init__(self, ni: int, nf: int, blur: bool = False):
        super().__init__()
        self.conv = Conv2d(ni, nf * 4, 1, bias=True)
        self.blur = blur

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = pixel_shuffle(F.relu(self.conv(x)), 2)
        return replication_blur(y) if self.blur else y


def _normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


class SelfAttention(nn.Module):
    """SAGAN-style self-attention over the spatial tokens (fastai
    SelfAttention): query and key projections to C/8, value to C, each
    spectral-normed; ``out = γ·(softmax over the source tokens of f·gᵀ)ᵀ·h
    + x``.

    Parameters keep flax's shapes: ``{query,key,value}_kernel`` (in, out)
    and ``gamma`` (1,). The power-iteration vectors ``{query,key,value}_u``
    (out,) are buffers (flax keeps them in ``batch_stats``), so the
    optimizer never sees them. Training mode runs one power-iteration step
    (v = normalize(K·u), u = normalize(vᵀ·K), both without gradient) and
    writes u back; eval mode recomputes v from the stored u. σ = vᵀ·K·u;
    each projection uses K / σ.

    The scores are taken in float32 from the compute-dtype projections,
    the softmax runs over the source tokens (JAX's axis 1, no 1/√d scale;
    here the scores are laid out [b, target, source] so that it runs over
    the contiguous last dim), and the output is γ·o + tokens in float32,
    cast back. The weighted sum of the values takes the softmax in the
    compute dtype; its bf16 product rounds to bf16 on the card (one
    rounding that JAX's float32 ``preferred_element_type`` skips; none in
    float32). A recompute under ``torch.utils.checkpoint`` reuses the
    (v, u) of the training forward it repeats and writes nothing. Under a
    space scope the targets are the rank's own tokens and the sources
    (f and h) every rank's, gathered: the softmax runs over the whole
    tile."""

    eps = 1e-12

    def __init__(self, c: int):
        super().__init__()
        nq = max(c // 8, 1)
        for name, nf in (("query", nq), ("key", nq), ("value", c)):
            self.register_parameter(f"{name}_kernel", nn.Parameter(torch.zeros(c, nf)))
            self.register_buffer(f"{name}_u", torch.full((nf,), 1 / math.sqrt(nf)))
        self.gamma = nn.Parameter(torch.zeros(1))
        self._iterate: dict = {}  # name -> (v, u) of the last training forward

    def _weight(self, name: str) -> torch.Tensor:
        k = getattr(self, f"{name}_kernel")
        u = getattr(self, f"{name}_u")
        if self.training and recomputing():
            v, u = self._iterate[name]
        elif self.training:
            with torch.no_grad():
                v = _normalize(k @ u, self.eps)
                u = _normalize(v @ k, self.eps)
                getattr(self, f"{name}_u").copy_(u)
            self._iterate[name] = (v, u)
        else:
            v = _normalize(k @ u, self.eps)
        sigma = v @ k @ u
        return k / torch.clamp(sigma, min=self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dt = x.dtype
        tokens = x.flatten(2).transpose(1, 2)                    # (b, hw, c)
        f = halo.gather_rows(tokens @ self._weight("query").to(dt), dim=1)
        g = tokens @ self._weight("key").to(dt)
        v = halo.gather_rows(tokens @ self._weight("value").to(dt), dim=1)
        s = torch.bmm(g.float(), f.float().transpose(1, 2))      # [b, j, i]
        beta = torch.softmax(s, dim=2)                           # over sources i
        o = torch.bmm(beta.to(dt), v).float()                    # [b, j, c]
        out = self.gamma * o + tokens.float()
        return out.to(dt).transpose(1, 2).reshape(b, c, h, w)
