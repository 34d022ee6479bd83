"""Plain reference of serving a scene: sliding windows (``windows``: step
patch − floor(patch·overlap), the last window snapped to each far edge),
each window's class probabilities (softmax of the logits), their mean over
the windows that cover a pixel, and the served class judged against it."""

from __future__ import annotations

import math

import torch

from ..harness.yardstick import windows

BATCH = 16  # windows a reference forward: a setting of the reference, not of the traffic


@torch.no_grad()
def probabilities(model: torch.nn.Module, scene: torch.Tensor, classes: int, patch: int,
                  overlap: float, scale: float, batch: int = BATCH) -> torch.Tensor:
    """(classes, H, W) float32 mean probabilities of a (bands, H, W) uint8
    scene on the model's device; ``model`` in eval mode returns logits."""
    _, h, w = scene.shape
    total = torch.zeros((classes, h, w), dtype=torch.float32, device=scene.device)
    count = torch.zeros((h, w), dtype=torch.float32, device=scene.device)
    offsets = windows(h, w, patch, overlap)
    for i in range(0, len(offsets), batch):
        chunk = offsets[i:i + batch]
        x = torch.stack([scene[:, y:y + patch, q:q + patch] for y, q in chunk]).float() * scale
        probs = torch.softmax(model(x).float(), dim=1)
        for p, (y, q) in zip(probs, chunk):
            total[:, y:y + patch, q:q + patch] += p
            count[y:y + patch, q:q + patch] += 1
    return total / count


def widest_gap(probs: torch.Tensor, served: torch.Tensor) -> float:
    """The widest margin, over all pixels, by which the reference's
    probability of the served class lies below its best; infinite where a
    served value is no class."""
    served = served.to(probs.device).long()
    if served.shape != probs.shape[1:] or served.min() < 0 or served.max() >= probs.shape[0]:
        return math.inf
    chosen = probs.gather(0, served[None])[0]
    return float((probs.max(dim=0).values - chosen).max())
