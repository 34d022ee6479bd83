"""Overlap-averaged mosaic assembly (a copy of ``unet_tpu/predict/merge.py``).

Host-side numpy, as in the JAX package: it reimplements the reference's
merge math bit for bit (predict.py:258-357): union extent from per-tile
geotransforms, sum raster + overlap counter, divide (integer ``//`` in
``large_file`` int8 mode, float otherwise), then argmax / class select,
with regression nodata −9999. The reference's quirks stay: the overlap
counter is int8, and ``large_file`` sums are int8. Tiles stream into the
mosaic as they are predicted instead of being held in RAM all at once
(the reference keeps every tile's probability stack in a list,
predict.py:220). ``save_predictions(device_merge=True)`` accumulates on
the card instead (``ops/blend.py`` ``DeviceMosaic``, placed by
``grid_layout``) and finishes there with ``finalize_mosaic_torch``, the
same divide / argmax / select on tensors, so only the finished output
crosses to the host; ``finalize_mosaic`` stays its plain version and the
host merge's finalize.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geo import tiff as tiff_codec


@dataclass
class TileInfo:
    """[ulx, xsize, xres, uly, ysize, yres] per tile (predict.py:222)."""

    path: str
    ulx: float
    xsize: int
    xres: float
    uly: float
    ysize: int
    yres: float
    crs: Optional[str]


def tile_extent_info(path: str) -> TileInfo:
    info = tiff_codec.read_info(path)
    if info.transform is None:
        raise ValueError(f"Tile {path} has no geotransform; cannot merge")
    t = info.transform
    return TileInfo(path=path, ulx=t[0], xsize=info.width, xres=t[1],
                    uly=t[3], ysize=info.height, yres=t[5], crs=info.crs)


def grid_layout(infos: List[TileInfo]) -> Tuple[np.ndarray, np.ndarray, int, int, Tuple[float, ...]]:
    """(rows, cols, y_length, x_length, transform) for equally-sized tiles
    on a shared grid — the device-merge fast path's placement table."""
    acc = MosaicAccumulator(infos)
    rows = np.array([round((i.uly - acc.upleft_y) / i.yres) for i in infos], np.int32)
    cols = np.array([round((i.ulx - acc.upleft_x) / i.xres) for i in infos], np.int32)
    transform = (acc.upleft_x, acc.xres, 0.0, acc.upleft_y, 0.0, acc.yres)
    return rows, cols, acc.y_length, acc.x_length, transform


def finalize_mosaic(
    merged: np.ndarray,
    counter: np.ndarray,
    regression: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
    large_file: bool = False,
) -> Tuple[np.ndarray, Optional[float]]:
    """Shared divide/argmax/select logic (predict.py:307-345)."""
    nodata: Optional[float] = None
    int8_mode = large_file and merged.dtype == np.int8
    merged = np.array(merged, dtype=np.int8 if int8_mode else np.float32)
    counter = np.asarray(counter)
    if regression:
        merged = merged[0] if merged.ndim == 3 else merged
        counter = counter[0] if counter.ndim == 3 else counter
        pos = counter > 0
        merged[pos] /= counter[pos]
        nodata = -9999
        merged[~pos] = nodata
        return merged, nodata
    if counter.ndim < merged.ndim:
        counter = np.broadcast_to(counter[None], merged.shape)
    pos = counter > 0
    if int8_mode:
        merged[pos] //= counter[pos].astype(np.int8)
    else:
        merged[pos] /= counter[pos]
    if all_classes:
        pass
    elif specific_class is None:
        merged = merged.argmax(axis=0).astype(np.uint8)
    else:
        merged = merged[specific_class]
    return merged, nodata


def finalize_mosaic_torch(
    summed: torch.Tensor,
    counter: torch.Tensor,
    regression: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[float]]:
    """``finalize_mosaic`` on tensors, on whatever device they lie: a
    (C, n, W) float32 sum and an (n, W) count give (output, nodata) —
    (n, W) uint8 class map, (C, n, W) ``all_classes`` or (n, W)
    ``specific_class`` probabilities, or (n, W) regression values with
    −9999 where the count is 0.

    Bit for bit ``finalize_mosaic``'s output on the same sums: the divide
    is IEEE float32 in both, a pixel no window reached keeps its sum (a
    bare divide would give 0/0 = NaN there, which ``torch.argmax`` takes
    for the largest value), and ``torch.argmax`` takes the first index on
    ties, as ``np.argmax`` does."""
    pos = counter > 0
    if regression:
        values = summed[0] if summed.dim() == 3 else summed
        return torch.where(pos, values / counter, torch.full_like(values, -9999.0)), -9999
    if specific_class is not None and not all_classes:
        summed = summed[specific_class]
    avg = torch.where(pos, summed / counter, summed)
    if all_classes or specific_class is not None:
        return avg, None
    return torch.argmax(avg, dim=0).to(torch.uint8), None


class MosaicAccumulator:
    def __init__(self, infos: List[TileInfo], large_file: bool = False):
        if not infos:
            raise ValueError("No tiles to merge")
        self.infos = {i.path: i for i in infos}
        self.large_file = large_file
        self.crs = infos[0].crs
        if len({i.crs for i in infos}) > 1:
            warnings.warn("Geoprojection is not the same for all prediction tiles.")
        if len({i.xres for i in infos}) != 1 or len({i.yres for i in infos}) != 1:
            warnings.warn("Not all tiles have the same resolution.")

        ulxs = np.array([i.ulx for i in infos])
        ulys = np.array([i.uly for i in infos])
        self.upleft_x = float(np.min(ulxs))
        self.upleft_y = float(np.max(ulys))
        xmax_i = int(np.argmax(ulxs))
        ymin_i = int(np.argmin(ulys))
        lowright_x = float(np.max(ulxs)) + infos[xmax_i].xsize * infos[xmax_i].xres
        lowright_y = float(np.min(ulys)) + infos[ymin_i].ysize * infos[ymin_i].yres
        self.xres = infos[0].xres
        self.yres = infos[0].yres
        self.x_length = round((lowright_x - self.upleft_x) / self.xres)
        self.y_length = round((lowright_y - self.upleft_y) / self.yres)
        self._sum: Optional[np.ndarray] = None
        self._counter: Optional[np.ndarray] = None

    def add(self, class_stack: np.ndarray, path: str) -> None:
        """Accumulate one tile's (C,H,W) prediction at its georeferenced
        location (predict.py:292-302)."""
        info = self.infos[path]
        if self._sum is None:
            dty = np.int8 if self.large_file else np.float32
            shape = (class_stack.shape[0], self.y_length, self.x_length)
            self._sum = np.zeros(shape, dtype=dty)
            self._counter = np.zeros(shape, dtype=np.int8)
            print(f"True merged raster size: {self._sum.nbytes / (1024 ** 2): .1f}MB.")
        ux = round((info.ulx - self.upleft_x) / info.xres)
        uy = round((info.uly - self.upleft_y) / info.yres)
        lx = round((info.ulx + info.xsize * info.xres - self.upleft_x) / info.xres)
        ly = round((info.uly + info.ysize * info.yres - self.upleft_y) / info.yres)
        self._sum[:, uy:ly, ux:lx] += class_stack.astype(self._sum.dtype)
        self._counter[:, uy:ly, ux:lx] += 1

    def finalize(
        self,
        regression: bool = False,
        all_classes: bool = False,
        specific_class: Optional[int] = None,
    ) -> Tuple[np.ndarray, Tuple[float, ...], Optional[float]]:
        """(mosaic, geotransform, nodata) — predict.py:307-355 semantics."""
        if self._sum is None:
            raise ValueError("No tiles were accumulated")
        merged, counter = self._sum, self._counter
        nodata: Optional[float] = None
        if regression:
            merged = merged[0]
            counter = counter[0]
            pos = counter > 0
            merged[pos] /= counter[pos]
            nodata = -9999
            merged[counter == 0] = nodata
        else:
            pos = counter > 0
            if self.large_file:
                merged[pos] //= counter[pos]
            else:
                merged[pos] /= counter[pos]
            if all_classes:
                pass
            elif specific_class is None:
                merged = merged.argmax(axis=0).astype(np.uint8)
            else:
                merged = merged[specific_class]
        transform = (self.upleft_x, self.xres, 0.0, self.upleft_y, 0.0, self.yres)
        return merged, transform, nodata
