"""PyTorch/CUDA port of ``unet_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
layout and names so each counterpart is easy to find, and imports neither
JAX nor anything of ``unet_tpu``. It runs the reference's pipeline: it
cuts scenes into tiles (``python -m unet_tpu_torch tile``), trains the
U-Net in both topologies, tpu_opt and the reference-shaped parity one,
with or without self-attention (``train``), predicts tile sets into tiles
or a merged mosaic (``predict``) and whole scenes (``serve``); it imports
fastai-trained models (``import-model``) and checks a machine
(``doctor``), with hand-written CUDA kernels under ``ops/csrc/`` and the
native tile decoder under ``native/``. ``run`` (``api.py``) drives the
reference's stages from a ``Params`` file, training resumes from its step
checkpoints, and ``parallel/mesh.py`` trains data-parallel over
processes.

Entry points take an explicit ``device`` (default ``"cuda"``) and never
fall back to the CPU unasked.
"""

from .utils.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
__all__ = ["resolve_device"]
