"""Whole-scene serving (any size) and tile-set prediction."""

from .predict import (  # noqa: F401
    Predictor,
    predict_raster,
    predict_raster_streamed,
    save_predictions,
    serve_scenes,
)
from .artifact import (  # noqa: F401
    ArtifactPredictor,
    export_artifact,
    is_artifact,
    load_artifact,
)
from .merge import (  # noqa: F401
    MosaicAccumulator,
    TileInfo,
    finalize_mosaic,
    finalize_mosaic_torch,
    tile_extent_info,
)
