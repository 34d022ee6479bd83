"""Segmentation loss with fastai ``CrossEntropyLossFlat`` semantics.

Counterpart of ``unet_tpu/train/losses.py`` for the classification loss:
torch's weighted-mean cross-entropy (the sum of w[y]·nll divided by the
sum of the selected class weights, not the element count). Logits are
class-first: (B, C, ...) with targets (B, ...). Targets outside [0, C)
count nothing, as a one-hot over C classes gives.

``fold_loss_layout`` lays out the sub-pixel head's pre-shuffle logits and
the full-resolution targets so the loss computes the full-resolution value
without a pixel shuffle.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

CROSS_ENTROPY_NAMES = ("cross_entropy", "crossentropylossflat", "ce")


def fold_loss_layout(logits: torch.Tensor,
                     targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, C·r², h, w) in (class, dy, dx) channel order and targets
    (B, h·r, w·r) → logits (B, C, r², h, w) and targets (B, r², h, w), the
    phase axis dy·r + dx in both. A pixel permutation, so any loss that
    reduces over all pixels gives the full-resolution value."""
    b, crr, h, w = logits.shape
    r = targets.shape[1] // h
    lg = logits.view(b, crr // (r * r), r * r, h, w)
    t = targets.reshape(b, h, r, w, r).permute(0, 2, 4, 1, 3).reshape(b, r * r, h, w)
    return lg, t


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``F.cross_entropy(..., weight, reduction='mean')`` in float32;
    ``sample_mask`` (B,) bool leaves padded samples out."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    t = targets.long()
    valid = (t >= 0) & (t < c)
    nll = -logp.gather(1, t.clamp(0, c - 1).unsqueeze(1)).squeeze(1)
    w = valid.float()
    if weight is not None:
        w = w * weight[t.clamp(0, c - 1)]
    if sample_mask is not None:
        w = w * sample_mask.float().view(-1, *([1] * (w.dim() - 1)))
    return (w * nll).sum() / w.sum()


def build_loss(name: Optional[str], weight: Optional[torch.Tensor] = None
               ) -> Callable[..., torch.Tensor]:
    """The loss by name: None or cross-entropy → weighted cross-entropy.
    The JAX package's other losses raise ``NotImplementedError``."""
    if name is None or name.lower() in CROSS_ENTROPY_NAMES:
        return lambda lg, t, sample_mask=None: cross_entropy(lg, t, weight, sample_mask)
    raise NotImplementedError(f"loss {name!r} is not yet ported (cross_entropy is)")
