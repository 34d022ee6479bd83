"""PyTorch/CUDA port of ``unet_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
layout and names so each counterpart is easy to find, and imports neither
JAX nor anything of ``unet_tpu``. This slice serves whole GeoTIFFs through
the tpu_opt U-Net: ``python -m unet_tpu_torch serve <bundle> scene.tif
out.tif``. The overlap-blend mosaic accumulates in a hand-written CUDA
kernel (``ops/csrc/blend_count.cu``).

Entry points take an explicit ``device`` (default ``"cuda"``) and never
fall back to the CPU unasked.
"""

from .utils.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
