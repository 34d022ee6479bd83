"""Streaming metrics with fastai's epoch semantics.

Counterpart of ``unet_tpu/train/metrics.py``: the sufficient statistics
are summed over the whole validation epoch and reduced once, so a value
does not depend on the batch size. DiceMulti keeps per-class intersection
and union of argmax predictions, two (C,) float32 tensors; rmse and R²
keep float32 scalar sums (squared and absolute errors, Σy, Σy², count).
All state stays on the device.
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


def regression_init(device="cpu") -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("sse", "sae", "sum_y", "sum_y2", "count")}


def regression_update(state: Dict[str, torch.Tensor], preds: torch.Tensor,
                      targets: torch.Tensor,
                      sample_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Add one batch: preds and targets (B, ...) in float32;
    ``sample_mask`` (B,) leaves padded samples out."""
    p, y = preds.float(), targets.float()
    if sample_mask is None:
        m = torch.ones_like(y)
    else:
        m = sample_mask.float().view(-1, *([1] * (y.dim() - 1))).expand_as(y)
    p, y, m = p.reshape(-1), y.reshape(-1), m.reshape(-1)
    return {"sse": state["sse"] + (m * (p - y) ** 2).sum(),
            "sae": state["sae"] + (m * (p - y).abs()).sum(),
            "sum_y": state["sum_y"] + (m * y).sum(),
            "sum_y2": state["sum_y2"] + (m * y * y).sum(),
            "count": state["count"] + m.sum()}


def rmse_value(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(state["sse"] / state["count"].clamp(min=1.0))


def r2_value(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """R² = 1 − SS_res / SS_tot from the streaming sums, with SS_tot =
    Σy² − (Σy)²/n floored at 1e-12, as the JAX package computes it."""
    n = state["count"].clamp(min=1.0)
    ss_tot = state["sum_y2"] - state["sum_y"] ** 2 / n
    return 1.0 - state["sse"] / ss_tot.clamp(min=1e-12)


def foreground_acc(logits: torch.Tensor, targets: torch.Tensor,
                   bkg_idx: int = 0) -> torch.Tensor:
    """fastai foreground_acc: accuracy of the argmax over the pixels whose
    target is not the background class; logits (B, C, ...)."""
    pred = logits.argmax(dim=1)
    mask = targets != bkg_idx
    correct = ((pred == targets) & mask).sum()
    return correct / mask.sum().clamp(min=1)
