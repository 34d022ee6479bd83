"""fastai Adam with one-cycle hyper-parameters and discriminative LR groups.

Counterpart of ``unet_tpu/train/optimizer.py``'s ``one_cycle_adam`` and,
with a schedule passed in, its ``constant_lr_adam`` (the LR finder's
sweep: one LR group, b1 = 0.9), written by hand because ``torch.optim.Adam``/``AdamW`` is another
algorithm. Its rules:

* b1 follows the momentum cycle and ``debias1 = 1 − b1**count`` uses the
  current b1; b2 = 0.99;
* the LR and b1 are evaluated at the pre-step count;
* eps = 1e-5 is added outside the square root;
* weight decay is decoupled (``lr·wd·p``, wd = 0.01) and applies only to
  parameters with more than one dimension;
* parameters fall into three LR groups by name — ``encoder.stem*`` → 0,
  other ``encoder.*`` → 1, the rest → 2 — with group LRs
  ``even_mults(lr/encoder_factor, lr, 3)``, each a constant multiple of
  the top group's schedule.

Scalars are float32, as the JAX package computes them, and each update
runs as PyTorch multi-tensor ops over one LR group at a time.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .schedule import discriminative_lrs, one_cycle_lr, one_cycle_momentum

# fastai's fit_one_cycle and Adam defaults, as the JAX package fixes them
PCT_START = 0.25
DIV = 25.0
DIV_FINAL = 1e5
MOMS = (0.95, 0.85, 0.95)
SQR_MOM = 0.99
EPS = 1e-5
WD = 0.01
N_GROUPS = 3


def param_group_label(name: str) -> int:
    """0 = encoder stem, 1 = encoder stages, 2 = decoder and head."""
    parts = name.split(".")
    if parts[0] == "encoder":
        return 0 if len(parts) > 1 and parts[1].startswith("stem") else 1
    return 2


class OneCycleAdam:
    """The reference's training optimizer over ``named_params`` (name,
    float32 parameter) pairs. ``step()`` applies one update from the
    parameters' ``.grad``. ``schedule`` = (lr_fn, mom_fn), each a function
    of the step giving a float32, replaces the one-cycle curves
    (``constant_lr_adam``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr: float, total_steps: int, encoder_factor: float = 10.0,
                 schedule: Optional[Tuple[Callable, Callable]] = None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if schedule is None:
            schedule = (one_cycle_lr(lr, total_steps, PCT_START, DIV, DIV_FINAL),
                        one_cycle_momentum(total_steps, MOMS, PCT_START))
        self.lr_fn, self.mom_fn = schedule
        group_lr_maxes = discriminative_lrs(lr, encoder_factor, N_GROUPS)
        self.scales = [float(group_lr_maxes[param_group_label(n)]) / float(lr)
                       for n in self.names]
        # leaves that share (LR scale, weight decay) update together
        self.groups: Dict[Tuple[float, bool], List[int]] = {}
        for i, (s, p) in enumerate(zip(self.scales, self.params)):
            self.groups.setdefault((s, p.dim() > 1), []).append(i)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def hypers(self, step: int) -> Tuple[np.float32, np.float32]:
        """(lr, b1) of the top group at ``step``, in float32."""
        return np.float32(self.lr_fn(step)), np.float32(self.mom_fn(step))

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        step0 = self.count
        self.count += 1
        lr, b1 = self.hypers(step0)
        one = np.float32(1.0)
        debias1 = float(one - b1 ** np.float32(self.count))
        debias2 = float(one - np.float32(SQR_MOM) ** np.float32(self.count))
        # mu = b1·mu + (1−b1)·g ; nu = b2·nu + (1−b2)·g·g
        torch._foreach_mul_(self.mu, float(b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, float(one - b1)))
        torch._foreach_mul_(self.nu, SQR_MOM)
        gg = torch._foreach_mul(grads, 1.0 - SQR_MOM)
        torch._foreach_mul_(gg, grads)
        torch._foreach_add_(self.nu, gg)
        del gg
        for (scale, decay), idx in self.groups.items():
            leaf_lr = lr * np.float32(scale)
            params = [self.params[i] for i in idx]
            # delta = −leaf_lr·(mu/debias1) / (sqrt(nu/debias2) + eps) [− leaf_lr·wd·p]
            delta = torch._foreach_div([self.mu[i] for i in idx], debias1)
            torch._foreach_mul_(delta, float(-leaf_lr))
            den = torch._foreach_div([self.nu[i] for i in idx], debias2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(delta, den)
            if decay:
                torch._foreach_sub_(delta, torch._foreach_mul(params, float(leaf_lr * np.float32(WD))))
            torch._foreach_add_(params, delta)


def constant_lr_adam(named_params: Iterable[Tuple[str, torch.Tensor]],
                     lr_fn: Callable[[int], float], mom: float = 0.9) -> OneCycleAdam:
    """The LR finder's optimizer: the same Adam, one LR group (every scale
    1), b1 fixed at ``mom`` and the LR ``lr_fn(step)``."""
    return OneCycleAdam(named_params, 1.0, 1, encoder_factor=1.0,
                        schedule=(lr_fn, lambda step: mom))
