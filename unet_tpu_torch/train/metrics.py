"""DiceMulti with fastai's epoch semantics.

Counterpart of ``unet_tpu/train/metrics.py``: per-class intersection and
union of argmax predictions are summed over the whole validation epoch and
reduced once, so the value does not depend on the batch size. The state is
two (C,) float32 tensors on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def dice_multi_init(n_classes: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {"inter": torch.zeros(n_classes, dtype=torch.float32, device=device),
            "union": torch.zeros(n_classes, dtype=torch.float32, device=device)}


def dice_multi_update(state: Dict[str, torch.Tensor], logits: torch.Tensor,
                      targets: torch.Tensor,
                      sample_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Add one batch: logits (B, C, H, W), targets (B, H, W); inter =
    |pred ∩ targ|, union = |pred| + |targ| per class; ``sample_mask`` (B,)
    leaves padded samples out."""
    n_c = state["inter"].shape[0]
    classes = torch.arange(n_c, device=logits.device).view(1, -1, 1, 1)
    pred1 = (logits.argmax(dim=1, keepdim=True) == classes).float()
    targ1 = (targets.long().unsqueeze(1) == classes).float()
    if sample_mask is not None:
        m = sample_mask.float().view(-1, 1, 1, 1)
        pred1, targ1 = pred1 * m, targ1 * m
    dims = (0, 2, 3)
    return {"inter": state["inter"] + (pred1 * targ1).sum(dim=dims),
            "union": state["union"] + pred1.sum(dim=dims) + targ1.sum(dim=dims)}


def dice_multi_value(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """nanmean of per-class binary dice: classes absent from both
    prediction and target (union 0) are left out."""
    union = state["union"]
    present = union > 0
    dice = torch.where(present, 2.0 * state["inter"] / torch.where(present, union, 1.0),
                       torch.zeros_like(union))
    return dice.sum() / present.sum().clamp(min=1)
