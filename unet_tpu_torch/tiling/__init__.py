"""Sliding windows over rasters, and GeoTIFF → training tiles."""

from .windows import Window, generate_windows  # noqa: F401
from .split import (SPLIT_DIRS, align_image_and_mask,  # noqa: F401
                    create_train_test_split, split_raster)
