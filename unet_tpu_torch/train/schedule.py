"""One-cycle schedules and discriminative learning rates.

Counterpart of ``unet_tpu/train/schedule.py`` (the LR-finder suggesters are
not ported yet): fastai's ``fit_one_cycle`` cosine warm-up and anneal of
the LR, the inverse momentum cycle ``moms=(0.95, 0.85, 0.95)``, and the
geometric spread of ``slice(lr/encoder_factor, lr)`` over parameter
groups.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

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
