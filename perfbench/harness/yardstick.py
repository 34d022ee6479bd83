"""The benchmark's yardstick: the card's published peaks and the work of the
port's hand-written kernels, counted from shapes.

The kernel arithmetic is a copy of the measured program's own
(``bound``, ``bn_work``, ``flip_work``, ``blend_work``), kept here so
that a change to the program cannot move the ruler it is measured by.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 / fp16 on the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def bn_work(shape: Sequence[int], element_size: int, backward: bool) -> Tuple[int, int]:
    """(bytes, operations) of one ``bn_stats`` call on an NCHW ``shape``:
    x (and dy in the backward) read once; a sum and a square-sum (the
    backward: the normalize, a product and two sums) a value. The (2, C)
    output is left out."""
    n = int(np.prod(shape))
    return (2 if backward else 1) * n * element_size, (5 if backward else 3) * n


def flip_work(b: int, c: int, h: int, w: int, image_size: int = 1,
              mask_size: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of one ``flip_scale`` call: images read in their
    dtype and written as float32, masks read and written, one multiply an
    image value."""
    n = b * c * h * w
    return n * (image_size + 4) + 2 * b * h * w * mask_size, n


def blend_work(n: int, c: int, th: int, tw: int, rows, cols) -> Tuple[int, int]:
    """(bytes, operations) of one ``blend_count`` call: each tile read
    once, the covered mosaic and count read and written once; one add per
    tile value and count."""
    h = int(max(rows)) + th
    w = int(max(cols)) + tw
    cover = np.zeros((h, w), bool)
    for r, q in zip(rows, cols):
        cover[r:r + th, q:q + tw] = True
    covered = int(cover.sum())
    return n * c * th * tw * 4 + 2 * covered * (c + 1) * 4, n * (c + 1) * th * tw


def windows(height: int, width: int, patch: int, overlap: float) -> List[Tuple[int, int]]:
    """(row, col) of each sliding window, x outer and y inner: step
    ``patch − floor(patch·overlap)``, a last window snapped to each far
    edge."""
    win_y, win_x = min(patch, height), min(patch, width)
    ys = list(range(0, height - win_y + 1, max(win_y - math.floor(win_y * overlap), 1)))
    xs = list(range(0, width - win_x + 1, max(win_x - math.floor(win_x * overlap), 1)))
    if ys[-1] != height - win_y:
        ys.append(height - win_y)
    if xs[-1] != width - win_x:
        xs.append(width - win_x)
    return [(y, x) for x in xs for y in ys]
