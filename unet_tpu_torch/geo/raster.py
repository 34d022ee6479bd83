"""Raster value object + geotransform math.

TPU-native replacement for the reference's scattered GDAL calls
(the reference utils.py:39-48 ``load_gdal``; create_tiles_unet.py:289
geotransform reads; predict.py:19-52 ``store_tif``). Raster codecs stay on
host (CPU) — the correct split, same as the reference — and hand dense numpy
arrays to the device pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from . import tiff

GeoTransform = Tuple[float, float, float, float, float, float]

IDENTITY_TRANSFORM: GeoTransform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)


@dataclass
class Raster:
    """A georeferenced multi-band raster: ``data`` is channels-first (C,H,W)."""

    data: np.ndarray
    transform: Optional[GeoTransform] = None
    crs: Optional[str] = None
    nodata: Optional[float] = None

    @property
    def bands(self) -> int:
        return self.data.shape[0]

    @property
    def height(self) -> int:
        return self.data.shape[1]

    @property
    def width(self) -> int:
        return self.data.shape[2]

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype

    def window(self, row0: int, row1: int, col0: int, col1: int) -> "Raster":
        """Crop by pixel window, shifting the geotransform accordingly.

        Matches the reference's crop-geotransform math at
        create_tiles_unet.py:224-226 (generalized to rotation-free grids).
        """
        sub = self.data[:, row0:row1, col0:col1]
        t = None
        if self.transform is not None:
            ulx, xres, xrot, uly, yrot, yres = self.transform
            t = (ulx + col0 * xres, xres, xrot, uly + row0 * yres, yrot, yres)
        return replace(self, data=sub, transform=t)


def read_raster(path: Union[str, Path]) -> Raster:
    data, info = tiff.read(str(path))
    return Raster(data=data, transform=info.transform, crs=info.crs, nodata=info.nodata)


def write_raster(
    path: Union[str, Path],
    raster_or_array: Union[Raster, np.ndarray],
    transform: Optional[GeoTransform] = None,
    crs: Optional[str] = None,
    nodata: Optional[float] = None,
    compress: Optional[str] = None,
) -> None:
    if isinstance(raster_or_array, Raster):
        r = raster_or_array
        tiff.write(str(path), r.data, transform=r.transform, crs=r.crs,
                   nodata=r.nodata, compress=compress)
    else:
        tiff.write(str(path), raster_or_array, transform=transform, crs=crs,
                   nodata=nodata, compress=compress)


def pixel_to_world(transform: GeoTransform, col: float, row: float) -> Tuple[float, float]:
    ulx, xres, xrot, uly, yrot, yres = transform
    return (ulx + col * xres + row * xrot, uly + col * yrot + row * yres)


def bounds(transform: GeoTransform, width: int, height: int) -> Tuple[float, float, float, float]:
    """(minx, miny, maxx, maxy) of a north-up raster."""
    ulx, xres, _, uly, _, yres = transform
    xs = (ulx, ulx + width * xres)
    ys = (uly, uly + height * yres)
    return (min(xs), min(ys), max(xs), max(ys))
