"""PyTorch/CUDA port of ``unet_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
layout and names so each counterpart is easy to find, and imports neither
JAX nor anything of ``unet_tpu``. It trains and serves the tpu_opt U-Net
(``python -m unet_tpu_torch train``, ``serve``) and checks a machine
(``doctor``), with hand-written CUDA kernels under ``ops/csrc/`` and the
native tile decoder under ``native/``.

Entry points take an explicit ``device`` (default ``"cuda"``) and never
fall back to the CPU unasked.
"""

from .utils.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
__all__ = ["resolve_device"]
