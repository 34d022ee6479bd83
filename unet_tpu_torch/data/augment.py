"""Input scaling for prediction (the training augmentations come with the
training slice)."""

from __future__ import annotations


def image_scale(dtype_str: str, normalize: str = "reference") -> float:
    """Scalar multiplier applied to raw tile values before the network."""
    if normalize == "reference":
        return 1.0 / 255.0 if dtype_str == "int16" else 1.0
    if normalize == "unit":
        return 1.0 / 65535.0 if dtype_str == "int16" else 1.0 / 255.0
    raise ValueError(f"Unknown normalize mode {normalize!r} (reference|unit)")
