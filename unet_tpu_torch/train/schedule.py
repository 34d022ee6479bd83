"""One-cycle schedules, discriminative learning rates and the LR finder.

Counterpart of ``unet_tpu/train/schedule.py``: fastai's ``fit_one_cycle``
cosine warm-up and anneal of the LR, the inverse momentum cycle
``moms=(0.95, 0.85, 0.95)``, the geometric spread of
``slice(lr/encoder_factor, lr)`` over parameter groups, and the LR
finder's exponential sweep with its four suggesters (minimum, steep,
valley, slide), host float64 as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np

Schedule = Callable[[int], float]


def cos_anneal(start: float, end: float, pos: float) -> float:
    """fastai SchedCos: cosine interpolation from start (pos=0) to end (pos=1)."""
    return start + (end - start) * (1.0 - math.cos(math.pi * pos)) / 2.0


def combined_cos(pct_start: float, start: float, middle: float, end: float,
                 total_steps: int) -> Schedule:
    """cos(start→middle) for the first ``pct_start`` of training, then
    cos(middle→end)."""
    warm = max(1, int(round(total_steps * pct_start)))

    def sched(step: int) -> float:
        step = min(step, total_steps)
        if step < warm:
            return cos_anneal(start, middle, step / warm)
        return cos_anneal(middle, end, (step - warm) / max(total_steps - warm, 1))

    return sched


def one_cycle_lr(lr_max: float, total_steps: int, pct_start: float = 0.25,
                 div: float = 25.0, div_final: float = 1e5) -> Schedule:
    """fit_one_cycle's LR curve with fastai defaults."""
    return combined_cos(pct_start, lr_max / div, lr_max, lr_max / div_final, total_steps)


def one_cycle_momentum(total_steps: int,
                       moms: Tuple[float, float, float] = (0.95, 0.85, 0.95),
                       pct_start: float = 0.25) -> Schedule:
    return combined_cos(pct_start, moms[0], moms[1], moms[2], total_steps)


def even_mults(start: float, stop: float, n: int) -> List[float]:
    """Geometric spacing from start to stop."""
    if n == 1:
        return [stop]
    step = (stop / start) ** (1.0 / (n - 1))
    return [start * step**i for i in range(n)]


def discriminative_lrs(lr: float, encoder_factor: float, n_groups: int = 3) -> List[float]:
    """``lr_max=slice(lr / encoder_factor, lr)`` over ``n_groups`` groups."""
    return even_mults(lr / encoder_factor, lr, n_groups)


# --- LR finder -----------------------------------------------------------------


def lr_finder_lrs(start_lr: float = 1e-7, end_lr: float = 10.0,
                  num_it: int = 100) -> np.ndarray:
    """The exponential LR sweep (fastai lr_find defaults)."""
    return np.exp(np.linspace(np.log(start_lr), np.log(end_lr), num_it))


def _smooth(losses: np.ndarray, beta: float = 0.98) -> np.ndarray:
    """fastai's debiased exponential moving average."""
    avg, out = 0.0, []
    for i, v in enumerate(losses):
        avg = beta * avg + (1 - beta) * v
        out.append(avg / (1 - beta ** (i + 1)))
    return np.asarray(out)


SUGGESTERS = ("minimum", "steep", "valley", "slide")


def suggest_lr(lrs: Sequence[float], losses: Sequence[float],
               method: str = "valley") -> float:
    """The LR a suggester picks from a sweep's smoothed losses: minimum
    (the minimum's LR / 10), steep (the steepest descent), slide (halfway
    back from the minimum to where the loss is still within 5% of it, /
    10) or valley (the default: about three quarters into the longest
    descending run)."""
    lrs = np.asarray(lrs, dtype=np.float64)
    losses = _smooth(np.asarray(losses, dtype=np.float64))
    if method == "minimum":
        return float(lrs[int(np.argmin(losses))] / 10.0)
    if method == "steep":
        grads = np.gradient(losses, np.log(lrs))
        return float(lrs[int(np.argmin(grads))])
    if method == "slide":
        idx_min = int(np.argmin(losses))
        loss_thresh = losses[idx_min] * 1.05 + 1e-12
        idx = idx_min
        while idx > 0 and losses[idx - 1] <= loss_thresh:
            idx -= 1
        return float(lrs[(idx + idx_min) // 2] / 10.0)
    n = len(losses)
    max_start, max_end = 0, 0
    lds = [1] * n
    for i in range(1, n):
        for j in range(0, i):
            if losses[i] < losses[j] and lds[i] < lds[j] + 1:
                lds[i] = lds[j] + 1
            if lds[max_end] < lds[i]:
                max_end = i
                max_start = max_end - lds[max_end]
    sections = (max_end - max_start) / 3
    return float(lrs[max_start + int(sections) + int(sections / 2)])
