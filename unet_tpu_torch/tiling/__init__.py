"""Sliding windows over rasters."""

from .windows import Window, generate_windows  # noqa: F401
