from .raster import (  # noqa: F401
    GeoTransform,
    IDENTITY_TRANSFORM,
    Raster,
    bounds,
    pixel_to_world,
    read_raster,
    write_raster,
)
from . import tiff  # noqa: F401
from .tiff import CRS  # noqa: F401
