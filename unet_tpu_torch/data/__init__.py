"""Tile datasets, the loader, class weights, augmentation and scaling."""

from .augment import (  # noqa: F401
    NOOP_AUGMENT,
    AugmentConfig,
    augment_batch,
    image_scale,
    n_augmented,
)
from .dataset import (  # noqa: F401
    TileDataset,
    get_datatype,
    get_image_tiles,
    get_mask_path,
    get_patch_size,
)
from .loader import TileLoader  # noqa: F401
from .weights import compute_class_weights, resolve_class_weights  # noqa: F401
