"""Sliding-window generation over rasters.

Reimplements the semantics the reference gets from the third-party
``slidingwindow`` package (create_tiles_unet.py:30-56, :403-428): clipped
window size, floor-based overlap step, and a final row/column snapped to the
raster edge for 100% coverage. Window iteration order is column-major
(x outer, y inner) to match the reference's tile indices exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Window:
    """A pixel-space window. ``x``/``y`` are col/row offsets."""

    x: int
    y: int
    w: int
    h: int

    def indices(self) -> Tuple[slice, slice]:
        """(row_slice, col_slice) for indexing an HWC or HW array."""
        return (slice(self.y, self.y + self.h), slice(self.x, self.x + self.w))

    def rect(self) -> Tuple[int, int, int, int]:
        return (self.x, self.y, self.w, self.h)


def generate_windows(height: int, width: int, patch_size: int, patch_overlap: float) -> List[Window]:
    """Overlapping square windows covering ``height × width``.

    Matches ``slidingwindow.generate(..., DimOrder.HeightWidthChannel,
    patch_size, patch_overlap)``: the window is clipped to the image when the
    image is smaller; step = size - floor(size*overlap); a final offset at
    the far edge is appended unless the grid already lands exactly on it.
    """
    if patch_overlap > 1:
        raise ValueError(f"Patch overlap {patch_overlap} must be between 0 - 1")
    win_x = min(patch_size, width)
    win_y = min(patch_size, height)
    step_x = win_x - int(math.floor(win_x * patch_overlap))
    step_y = win_y - int(math.floor(win_y * patch_overlap))
    last_x = width - win_x
    last_y = height - win_y
    xs = list(range(0, last_x + 1, max(step_x, 1)))
    ys = list(range(0, last_y + 1, max(step_y, 1)))
    if not xs or xs[-1] != last_x:
        xs.append(last_x)
    if not ys or ys[-1] != last_y:
        ys.append(last_y)
    return [Window(x, y, win_x, win_y) for x in xs for y in ys]
