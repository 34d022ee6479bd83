"""Segmentation and regression losses with fastai ``*Flat`` semantics.

Counterpart of ``unet_tpu/train/losses.py``. Logits are class-first:
(B, C, ...) with targets (B, ...); regression predictions are (B, ...),
the model's channel 0, with float targets of the same shape.

* ``cross_entropy``: torch's weighted-mean cross-entropy (the sum of
  w[y]·nll divided by the sum of the selected class weights, not the
  element count). Targets outside [0, C) count nothing, as a one-hot over
  C classes gives.
* ``focal_loss``: fastai's focal loss over the per-pixel weighted nll, a
  plain mean over every pixel of the kept samples. A target outside
  [0, C) has nll 0 there but still counts in the mean, as in the JAX
  package.
* ``mse_loss``, ``l1_loss``, ``smooth_l1_loss`` (β = 0.5): float32 means
  over every pixel of the kept samples.
* ``dice_loss``: fastai's DiceLoss, softmax probabilities in float32,
  ``1 − dice`` per (sample, class) summed (``reduction='sum'``).

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


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
               weight: Optional[torch.Tensor] = None,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fastai FocalLoss in float32: ``((1 - exp(-ce))**gamma * ce).mean()``
    with ce = w[y]·nll, the class weight applied before ``exp``. The mean
    runs over every pixel of the samples ``sample_mask`` (B,) keeps, not
    over the weights; a target outside [0, C) gives ce = 0 and still
    counts in it."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    t = targets.long()
    tc = t.clamp(0, c - 1)
    nll = -logp.gather(1, tc.unsqueeze(1)).squeeze(1) * ((t >= 0) & (t < c))
    if weight is not None:
        nll = nll * weight[tc]
    m = torch.ones_like(nll)
    if sample_mask is not None:
        m = m * sample_mask.float().view(-1, *([1] * (m.dim() - 1)))
    return ((1.0 - torch.exp(-nll)) ** gamma * nll * m).sum() / m.sum()


def _pixel_mask(vals: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """A per-sample mask (B,) broadcast to the pixels of ``vals``."""
    if sample_mask is None:
        return torch.ones_like(vals)
    return sample_mask.float().view(-1, *([1] * (vals.dim() - 1))).expand_as(vals)


def _masked_mean(vals: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    m = _pixel_mask(vals, sample_mask)
    return (vals * m).sum() / m.sum()


def mse_loss(preds: torch.Tensor, targets: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSELossFlat."""
    return _masked_mean((preds.float() - targets.float()) ** 2, sample_mask)


def l1_loss(preds: torch.Tensor, targets: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1LossFlat."""
    return _masked_mean((preds.float() - targets.float()).abs(), sample_mask)


def smooth_l1_loss(preds: torch.Tensor, targets: torch.Tensor, beta: float = 0.5,
                   sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's ``Smoothl1``: torch SmoothL1Loss with β = 0.5."""
    d = (preds.float() - targets.float()).abs()
    return _masked_mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta),
                        sample_mask)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-6,
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fastai DiceLoss (``reduction='sum'``): softmax probabilities over the
    class axis 1, per-(sample, class) dice over every other axis, ``1 −
    dice`` summed; ``sample_mask`` (B,) zeroes padded samples' terms."""
    c = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    classes = torch.arange(c, device=logits.device).view(1, c, *([1] * (targets.dim() - 1)))
    onehot = (targets.long().unsqueeze(1) == classes).float()
    dims = tuple(range(2, probs.dim()))
    inter = (probs * onehot).sum(dim=dims)
    union = (probs + onehot).sum(dim=dims)
    loss = 1.0 - (2.0 * inter + smooth) / (union + smooth)
    if sample_mask is not None:
        loss = loss * sample_mask.float()[:, None]
    return loss.sum()


FOCAL_NAMES = ("focal", "focallossflat")
FOCAL_GAMMA = 2.0  # the JAX package's build_loss default, the one in use
LOSSES = {"mse": (mse_loss, ("mse", "mselossflat")),
          "l1": (l1_loss, ("l1", "l1lossflat")),
          "smooth_l1": (smooth_l1_loss, ("smooth_l1", "smoothl1")),
          "dice": (dice_loss, ("dice", "diceloss"))}


def build_loss(name: Optional[str], weight: Optional[torch.Tensor] = None,
               regression: bool = False) -> Callable[..., torch.Tensor]:
    """The loss by name, with the reference's defaults: None → MSE for
    regression, weighted cross-entropy otherwise; focal → weighted focal
    loss with γ = 2; mse, l1, smooth_l1 and dice (and their fastai class
    names) unweighted."""
    if name is None:
        name = "mse" if regression else "cross_entropy"
    key = name.lower()
    if key in CROSS_ENTROPY_NAMES:
        return lambda lg, t, sample_mask=None: cross_entropy(lg, t, weight, sample_mask)
    if key in FOCAL_NAMES:
        return lambda lg, t, sample_mask=None: focal_loss(lg, t, FOCAL_GAMMA, weight,
                                                          sample_mask)
    for fn, names in LOSSES.values():
        if key in names:
            return fn
    raise ValueError(f"Unknown loss {name!r}; options: "
                     f"{sorted(['cross_entropy', 'focal', *LOSSES])}")
