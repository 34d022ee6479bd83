"""On-device batch augmentation and value scaling.

Counterpart of ``unet_tpu/data/augment.py``, flips only:

* the default pipeline is HorizontalFlip(p=.5) + VerticalFlip(p=.5);
* only the first ``ceil(B · n_transform_imgs)`` samples of a batch are
  augmented;
* values are scaled per detected dtype (``image_scale``);
* ``split_idx`` gates augmentation: 0 → train batches only, 1 → valid only,
  None → both; other batches are only scaled.

The flip flags come from an explicit ``torch.Generator`` (they are not
JAX's draws). Widening, flips and scaling run in one pass,
``ops.aug.fused_flip_scale`` (the ``flip_scale`` CUDA kernel on the card).
An ``AugmentConfig`` asking for more than flips raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..ops.aug import fused_flip_scale


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

    def flips_only(self) -> bool:
        return (self.rot90_p == 0 and self.brightness_contrast_p == 0
                and self.saturation_p == 0 and self.coarse_dropout_p == 0)


NOOP_AUGMENT = AugmentConfig(hflip_p=0.0, vflip_p=0.0)


def image_scale(dtype_str: str, normalize: str = "reference") -> float:
    """Scalar multiplier applied to raw tile values before the network."""
    if normalize == "reference":
        return 1.0 / 255.0 if dtype_str == "int16" else 1.0
    if normalize == "unit":
        return 1.0 / 65535.0 if dtype_str == "int16" else 1.0 / 255.0
    raise ValueError(f"Unknown normalize mode {normalize!r} (reference|unit)")


def value_max(dtype_str: str, normalize: str = "reference") -> float:
    """Upper end of the post-scaling value range."""
    if normalize == "unit":
        return 1.0
    return 257.0 if dtype_str == "int16" else 255.0


def n_augmented(batch_size: int, n_transform_imgs: float) -> int:
    if not (0 <= n_transform_imgs <= 1):
        raise ValueError(
            f"The n_transform_imgs parameter ({n_transform_imgs}) must be between 1 and 0."
        )
    return min(math.ceil(batch_size * n_transform_imgs), batch_size)


def augment_active(split: str, split_idx: Optional[int]) -> bool:
    """Whether ``split_idx`` lets a ``split`` batch be augmented."""
    return split_idx is None or (split_idx == 0 and split == "train") or (
        split_idx == 1 and split == "valid")


def flip_flags(batch_size: int, n_aug: int, cfg: AugmentConfig,
               generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hflip, vflip) host bool flags: sample i < n_aug flips with the
    config's probabilities, the others never."""
    u = torch.rand((2, batch_size), generator=generator)
    in_range = torch.arange(batch_size) < n_aug
    return in_range & (u[0] < cfg.hflip_p), in_range & (u[1] < cfg.vflip_p)


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
    flip_scale: Callable = fused_flip_scale,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scale + (conditionally) flip one device batch.

    ``images``: (B,C,H,W) raw tile values in their storage dtype; masks
    (B,H,W) or None. Returns float32 images and the masks in their dtype.
    ``flip_scale`` is the pass that applies flags and scales
    (``fused_flip_scale``; ``fused_flip_scale_reference`` holds the kernel
    against its plain version on the card)."""
    if not cfg.flips_only():
        raise NotImplementedError(
            f"augmentations other than flips ({cfg.describe()}) are not yet ported")
    b = images.shape[0]
    n_aug = n_augmented(b, n_transform_imgs)
    scales = torch.full((b,), image_scale(dtype_str, normalize), dtype=torch.float32)
    if augment_active(split, split_idx) and n_aug > 0:
        hflip, vflip = flip_flags(b, n_aug, cfg, generator)
    else:
        hflip = vflip = torch.zeros(b, dtype=torch.bool)
    return flip_scale(images, masks, hflip, vflip, scales)
