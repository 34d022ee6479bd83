"""Plain references of a training step of the segmentation U-Net, after
fastai's defaults as the reference trainer uses them: per-sample flips
drawn as uniform numbers against their probabilities, the uint8 values
scaled, class-weighted cross entropy (inverse class frequency over the
training masks), and ``fit_one_cycle``'s Adam: cosine warm-up and anneal
of the LR and the inverse momentum cycle, ``slice(lr/encoder_factor,
lr)`` over three parameter groups (encoder stem, encoder stages, the
rest), eps outside the square root, decoupled weight decay 0.01 on
parameters of more than one dimension."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PCT_START, DIV, DIV_FINAL = 0.25, 25.0, 1e5
MOMS = (0.95, 0.85, 0.95)
SQR_MOM, EPS, WD = 0.99, 1e-5, 0.01


def flip_draws(generator: torch.Generator, batch: int, hflip_p: float,
               vflip_p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's (hflip, vflip) flags: two uniform numbers a sample."""
    u = torch.rand((2, batch), generator=generator)
    return u[0] < hflip_p, u[1] < vflip_p


def augment(images: torch.Tensor, masks: torch.Tensor, hflip: torch.Tensor,
            vflip: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip each sample as its flags say; images to float32 times ``scale``."""
    x, y = images.float() * scale, masks.long()
    for i in range(x.shape[0]):
        dims = [d for d, on in ((-1, hflip[i]), (-2, vflip[i])) if on]
        if dims:
            x[i], y[i] = x[i].flip(dims), y[i].flip(dims)
    return x, y


def class_weights(masks: np.ndarray, classes: int) -> List[float]:
    """Inverse frequency: all pixels over each class's, 0 for a class that
    never occurs."""
    counts = np.bincount(masks.reshape(-1), minlength=classes)[:classes].astype(np.float64)
    total = counts.sum()
    return [total / c if c else 0.0 for c in counts]


def weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Σ w[y]·nll / Σ w[y]."""
    nll = F.cross_entropy(logits, target, reduction="none")
    w = weight[target]
    return (w * nll).sum() / w.sum()


def _cos(start: float, end: float, pos: float) -> float:
    return start + (end - start) * (1.0 - math.cos(math.pi * pos)) / 2.0


def one_cycle(start: float, middle: float, end: float, total: int, step: int) -> float:
    warm = max(1, int(round(total * PCT_START)))
    step = min(step, total)
    if step < warm:
        return _cos(start, middle, step / warm)
    return _cos(middle, end, (step - warm) / max(total - warm, 1))


def group_of(name: str) -> int:
    parts = name.split(".")
    if parts[0] == "encoder":
        return 0 if len(parts) > 1 and parts[1].startswith("stem") else 1
    return 2


class OneCycleAdam:
    def __init__(self, named: Sequence[Tuple[str, torch.Tensor]], lr: float,
                 total_steps: int, encoder_factor: float):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.total = lr, total_steps
        lo = lr / encoder_factor
        mults = [lo * (lr / lo) ** (i / 2) for i in range(3)]
        self.scale = [mults[group_of(n)] / lr for n in self.names]
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        lr = one_cycle(self.lr / DIV, self.lr, self.lr / DIV_FINAL, self.total, self.count)
        b1 = one_cycle(MOMS[0], MOMS[1], MOMS[2], self.total, self.count)
        self.count += 1
        d1, d2 = 1 - b1 ** self.count, 1 - SQR_MOM ** self.count
        for p, mu, nu, s in zip(self.params, self.mu, self.nu, self.scale):
            g = p.grad
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(SQR_MOM).addcmul_(g, g, value=1 - SQR_MOM)
            step = (mu / d1) / ((nu / d2).sqrt() + EPS)
            if p.dim() > 1:
                step = step + WD * p
            p.sub_(lr * s * step)
