"""Whole-scene serving and tile-set prediction."""

from .predict import Predictor, predict_raster, save_predictions, serve_scenes  # noqa: F401
from .merge import MosaicAccumulator, TileInfo, tile_extent_info  # noqa: F401
