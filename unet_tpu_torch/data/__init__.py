"""Input scaling."""

from .augment import image_scale  # noqa: F401
