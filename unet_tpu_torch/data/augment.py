"""On-device batch augmentation and value scaling.

Counterpart of ``unet_tpu/data/augment.py``, every ``AugmentConfig`` op:

* the default pipeline is HorizontalFlip(p=.5) + VerticalFlip(p=.5);
  RandomRotate90 (square tiles only), RandomBrightnessContrast,
  Saturation and CoarseDropout are there as the reference keeps them;
* only the first ``ceil(B · n_transform_imgs)`` samples of a batch are
  augmented; under ``reference_quirks`` a fraction of exactly 1.0 augments
  none of them (the reference's off-by-one);
* values are scaled per detected dtype (``image_scale``); under
  ``reference_quirks`` augmented int16 samples get the reference's
  ``(255/65535)/scale`` times that scale;
* ``split_idx`` gates augmentation: 0 → train batches only, 1 → valid only,
  None → both; other batches are only scaled.

The random parameters are drawn apart from their application:
``draw_augment`` makes them from an explicit ``torch.Generator`` on the host
(they are not JAX's draws), and ``apply_augment`` applies any set of them,
so the same draws give the JAX package's result. JAX's order is scale,
rot90, hflip, vflip, brightness/contrast, saturation, dropout. Here rot90
comes first, on the tiles and masks in their storage dtypes (a permutation,
which commutes with the per-sample scale); then one ``flip_scale`` pass
(``ops.aug.fused_flip_scale``, the CUDA kernel on the card) widens, flips
and scales; then the photometric passes and the dropout run in plain
PyTorch on float32. The result is JAX's, and the kernel stays on the path
whatever the config.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.aug import _SIGNED_VIEW, fused_flip_scale


@dataclass(frozen=True)
class AugmentConfig:
    hflip_p: float = 0.5
    vflip_p: float = 0.5
    rot90_p: float = 0.0
    brightness_limit: Tuple[float, float] = (-0.1, 0.1)
    contrast_limit: Tuple[float, float] = (-0.1, 0.1)
    brightness_contrast_p: float = 0.0
    saturation_limit: Tuple[float, float] = (-0.3, 0.3)
    saturation_p: float = 0.0
    coarse_dropout_p: float = 0.0
    dropout_holes: int = 8
    dropout_size: int = 8

    def describe(self) -> dict:
        """Transform-name → probability map for the run manifest."""
        d = {}
        if self.hflip_p:
            d["HorizontalFlip"] = self.hflip_p
        if self.vflip_p:
            d["VerticalFlip"] = self.vflip_p
        if self.rot90_p:
            d["RandomRotate90"] = self.rot90_p
        if self.brightness_contrast_p:
            d["RandomBrightnessContrast"] = self.brightness_contrast_p
        if self.saturation_p:
            d["Saturation"] = self.saturation_p
        if self.coarse_dropout_p:
            d["CoarseDropout"] = self.coarse_dropout_p
        if not d:
            d["NoOp"] = 1.0
        return d


NOOP_AUGMENT = AugmentConfig(hflip_p=0.0, vflip_p=0.0)


def image_scale(dtype_str: str, normalize: str = "reference") -> float:
    """Scalar multiplier applied to raw tile values before the network."""
    if normalize == "reference":
        return 1.0 / 255.0 if dtype_str == "int16" else 1.0
    if normalize == "unit":
        return 1.0 / 65535.0 if dtype_str == "int16" else 1.0 / 255.0
    raise ValueError(f"Unknown normalize mode {normalize!r} (reference|unit)")


def value_max(dtype_str: str, normalize: str = "reference") -> float:
    """Upper end of the post-scaling value range (for brightness offsets)."""
    if normalize == "unit":
        return 1.0
    return 257.0 if dtype_str == "int16" else 255.0


def n_augmented(batch_size: int, n_transform_imgs: float,
                reference_quirks: bool = False) -> int:
    if not (0 <= n_transform_imgs <= 1):
        raise ValueError(
            f"The n_transform_imgs parameter ({n_transform_imgs}) must be between 1 and 0."
        )
    n = math.ceil(batch_size * n_transform_imgs)
    if reference_quirks and n >= batch_size:
        return 0  # the reference's slice [:ceil(B·1) - B] == [:0]
    return min(n, batch_size)


def augment_active(split: str, split_idx: Optional[int]) -> bool:
    """Whether ``split_idx`` lets a ``split`` batch be augmented."""
    return split_idx is None or (split_idx == 0 and split == "train") or (
        split_idx == 1 and split == "valid")


def sample_scales(b: int, n_aug: int, dtype_str: str, normalize: str,
                  reference_quirks: bool) -> torch.Tensor:
    """(B,) float32 value scales: ``image_scale``, and under
    ``reference_quirks`` for int16 tiles the reference's ``255/65535``
    on the first ``n_aug`` (augmented) samples."""
    scale = image_scale(dtype_str, normalize)
    scales = torch.full((b,), scale, dtype=torch.float32)
    if reference_quirks and dtype_str == "int16" and n_aug > 0:
        scales[:n_aug] = scale * ((255.0 / 65535.0) / scale)
    return scales


@dataclass
class AugmentDraws:
    """Per-sample parameters of one batch's augmentation, host tensors: the
    rot90 count ``rot_k`` (B,) (0 = none), the flip flags (B,), the
    brightness/contrast gate, α and β (B,), the saturation gate and factor
    (B,), the dropout gate (B,) and the hole corners ``holes`` (n_holes,
    2, B) as (row, col)."""

    rot_k: torch.Tensor
    hflip: torch.Tensor
    vflip: torch.Tensor
    bc: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    sat: torch.Tensor
    sat_factor: torch.Tensor
    drop: torch.Tensor
    holes: torch.Tensor

    @classmethod
    def none(cls, b: int, cfg: AugmentConfig) -> "AugmentDraws":
        """No op on any sample: the draws of an unaugmented batch."""
        off = torch.zeros(b, dtype=torch.bool)
        ones = torch.ones(b, dtype=torch.float32)
        return cls(torch.zeros(b, dtype=torch.int64), off, off, off, ones,
                   torch.zeros(b, dtype=torch.float32), off, ones, off,
                   torch.zeros((cfg.dropout_holes, 2, b), dtype=torch.int64))

    def take(self, idx: torch.Tensor) -> "AugmentDraws":
        """The draws of the samples ``idx`` (a rank's share of the batch)."""
        return AugmentDraws(**{f.name: getattr(self, f.name)[..., idx] if f.name == "holes"
                               else getattr(self, f.name)[idx]
                               for f in dataclasses.fields(self)})


def flip_flags(batch_size: int, n_aug: int, cfg: AugmentConfig,
               generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hflip, vflip) host bool flags: sample i < n_aug flips with the
    config's probabilities, the others never."""
    u = torch.rand((2, batch_size), generator=generator)
    in_range = torch.arange(batch_size) < n_aug
    return in_range & (u[0] < cfg.hflip_p), in_range & (u[1] < cfg.vflip_p)


def _uniform(b: int, lo_hi: Tuple[float, float], generator: torch.Generator) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(b, generator=generator)


def draw_augment(b: int, h: int, w: int, cfg: AugmentConfig, n_aug: int,
                 generator: torch.Generator) -> AugmentDraws:
    """The parameters of one batch of ``b`` (h, w) tiles: each op's gate
    is on for sample i < ``n_aug`` with the op's probability. The flip
    flags are drawn first, as ``flip_flags`` draws them; an op whose
    probability is 0 draws nothing."""
    d = AugmentDraws.none(b, cfg)
    d.hflip, d.vflip = flip_flags(b, n_aug, cfg, generator)
    in_range = torch.arange(b) < n_aug

    def gate(p: float) -> torch.Tensor:
        return in_range & (torch.rand(b, generator=generator) < p)

    if cfg.rot90_p > 0 and h == w:
        on = gate(cfg.rot90_p)
        d.rot_k = torch.where(on, torch.randint(1, 4, (b,), generator=generator), 0)
    if cfg.brightness_contrast_p > 0:
        d.bc = gate(cfg.brightness_contrast_p)
        d.alpha = 1.0 + _uniform(b, cfg.contrast_limit, generator)
        d.beta = _uniform(b, cfg.brightness_limit, generator)
    if cfg.saturation_p > 0:
        d.sat = gate(cfg.saturation_p)
        d.sat_factor = 1.0 + _uniform(b, cfg.saturation_limit, generator)
    if cfg.coarse_dropout_p > 0:
        d.drop = gate(cfg.coarse_dropout_p)
        highs = torch.tensor([max(h - cfg.dropout_size, 1), max(w - cfg.dropout_size, 1)])
        u = torch.rand((cfg.dropout_holes, 2, b), generator=generator, dtype=torch.float64)
        d.holes = (u * highs.view(1, 2, 1)).long()
    return d


def _signed(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed with a signed dtype of its width where PyTorch cannot
    index or flip its own (the bits move as they are)."""
    return t.view(_SIGNED_VIEW[t.dtype]) if t.dtype in _SIGNED_VIEW else t


def rot90_pass(images: torch.Tensor, masks: Optional[torch.Tensor],
               rot_k: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rotate sample i of (B, C, H, H) images and (B, H, H) masks by
    ``rot_k[i]`` quarter turns (``jnp.rot90`` over the spatial axes), in
    their dtypes; new tensors where a sample turns, the inputs otherwise."""
    if not bool(rot_k.any()):
        return images, masks
    out = [None if t is None else _signed(t).clone() for t in (images, masks)]
    for k in (1, 2, 3):
        idx = torch.nonzero(rot_k == k).flatten()
        if idx.numel() == 0:
            continue
        idx = idx.to(images.device)
        for t in out:
            if t is not None:
                t[idx] = torch.rot90(t[idx], k, (t.dim() - 2, t.dim() - 1))
    return tuple(None if t is None else t.view(src.dtype)
                 for t, src in zip(out, (images, masks)))


def photometric_pass(images: torch.Tensor, draws: AugmentDraws, cfg: AugmentConfig,
                     max_val: float) -> torch.Tensor:
    """Brightness/contrast (``x·α + β·max_val``), saturation (towards the
    channel mean by the factor) and coarse dropout (zeroed square holes)
    on float32 (B, C, H, W) images, each where its gate is on, in JAX's
    order (``cfg`` gives the holes' size); plain PyTorch."""
    b, _, h, w = images.shape
    dev = images.device

    def per_sample(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev).view(b, 1, 1, 1)

    if bool(draws.bc.any()):
        adjusted = images * per_sample(draws.alpha) + per_sample(draws.beta * max_val)
        images = torch.where(per_sample(draws.bc), adjusted, images)
    if bool(draws.sat.any()):
        gray = images.mean(dim=1, keepdim=True)
        adjusted = gray + (images - gray) * per_sample(draws.sat_factor)
        images = torch.where(per_sample(draws.sat), adjusted, images)
    if bool(draws.drop.any()):
        size = cfg.dropout_size
        holes = draws.holes.to(dev)
        rows = torch.arange(h, device=dev).view(1, 1, h)
        cols = torch.arange(w, device=dev).view(1, 1, w)
        r0, c0 = holes[:, 0, :, None], holes[:, 1, :, None]  # (n_holes, B, 1)
        in_rows = (rows >= r0) & (rows < r0 + size)  # (n_holes, B, H)
        in_cols = (cols >= c0) & (cols < c0 + size)
        hole = (in_rows[..., :, None] & in_cols[..., None, :]).any(dim=0)  # (B, H, W)
        keep = ~(hole & draws.drop.to(dev).view(b, 1, 1))
        images = images * keep[:, None].to(images.dtype)
    return images


def apply_augment(images: torch.Tensor, masks: Optional[torch.Tensor],
                  draws: AugmentDraws, scales: torch.Tensor, cfg: AugmentConfig,
                  max_val: float, flip_scale: Callable = fused_flip_scale
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply ``draws`` to (B, C, H, W) storage-dtype images and (B, H, W)
    masks (or None): rot90, then ``flip_scale`` (flips and the (B,)
    ``scales``; float32 masks go through it as their int32 bits), then the
    photometric passes. Returns float32 images and the masks in their
    dtype."""
    images, masks = rot90_pass(images, masks, draws.rot_k)
    float_masks = masks is not None and masks.dtype == torch.float32
    m_in = masks.view(torch.int32) if float_masks else masks
    images, m_out = flip_scale(images, m_in, draws.hflip, draws.vflip, scales)
    masks = m_out.view(torch.float32) if float_masks else m_out
    return photometric_pass(images, draws, cfg, max_val), masks


def augment_batch(
    images: torch.Tensor,
    masks: Optional[torch.Tensor],
    cfg: AugmentConfig,
    generator: torch.Generator,
    n_transform_imgs: float = 1.0,
    dtype_str: str = "int8",
    normalize: str = "reference",
    split: str = "train",
    split_idx: Optional[int] = 0,
    reference_quirks: bool = False,
    flip_scale: Callable = fused_flip_scale,
    batch_size: Optional[int] = None,
    shard: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scale + (conditionally) augment one device batch.

    ``images``: (B,C,H,W) raw tile values in their storage dtype; masks
    (B,H,W) or None. Returns float32 images and the masks in their dtype.
    ``flip_scale`` is the pass that applies flags and scales
    (``fused_flip_scale``; ``fused_flip_scale_reference`` holds the kernel
    against its plain version on the card). Under data parallelism the
    images are the samples ``shard`` of a ``batch_size`` batch: the draws
    and scales are made for the whole batch, as every rank makes them, and
    the shard's are applied."""
    b, _, h, w = images.shape
    if shard is not None:
        b = batch_size
    n_aug = n_augmented(b, n_transform_imgs, reference_quirks)
    active = augment_active(split, split_idx) and n_aug > 0
    scales = sample_scales(b, n_aug if active else 0, dtype_str, normalize,
                           reference_quirks)
    draws = (draw_augment(b, h, w, cfg, n_aug, generator) if active
             else AugmentDraws.none(b, cfg))
    if shard is not None:
        idx = torch.as_tensor(shard, dtype=torch.int64)
        draws, scales = draws.take(idx), scales[idx]
    return apply_augment(images, masks, draws, scales, cfg,
                         value_max(dtype_str, normalize), flip_scale)
