"""Whole-scene serving."""

from .predict import Predictor, predict_raster, serve_scenes  # noqa: F401
