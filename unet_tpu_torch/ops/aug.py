"""Per-sample flip + value scaling of a training batch, in one pass.

Counterpart of ``unet_tpu/ops/pallas_aug.py``. ``fused_flip_scale(images,
masks, hflip, vflip, scales)`` takes NCHW tiles in their storage dtype
(uint8, uint16, int16 or float32) and (B, H, W) integer masks, flips each
sample horizontally and/or vertically, widens the images to float32 and
multiplies each sample by its scale; the masks come out flipped in their
own dtype. For CUDA tensors it launches the CUDA kernel
``csrc/flip_scale.cu`` (one read and one write per tile, images and masks
in one launch) or raises; for CPU tensors it runs the plain version,
``fused_flip_scale_reference``. Both give the bits of
``x.float().flip(...) * scale``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_IMAGE_KINDS = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2, torch.float32: 3}
_MASK_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.uint16,
                torch.int32, torch.uint32, torch.int64)


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _flip(t: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor) -> torch.Tensor:
    if t.dtype in _SIGNED_VIEW:  # PyTorch cannot flip these; the bits move as they are
        return _flip(t.view(_SIGNED_VIEW[t.dtype]), hflip, vflip).view(t.dtype)
    shape = (-1,) + (1,) * (t.dim() - 1)
    t = torch.where(hflip.view(shape), t.flip(-1), t)
    return torch.where(vflip.view(shape), t.flip(-2), t)


def fused_flip_scale_reference(
        images: torch.Tensor, masks: Optional[torch.Tensor],
        hflip: torch.Tensor, vflip: torch.Tensor,
        scales: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``fused_flip_scale``."""
    dev = images.device
    hflip, vflip = hflip.to(dev, torch.bool), vflip.to(dev, torch.bool)
    out = _flip(images.float(), hflip, vflip) * scales.to(dev, torch.float32).view(-1, 1, 1, 1)
    return out, None if masks is None else _flip(masks, hflip, vflip)


def _load_kernel():
    from . import _build

    fn = _build.load("flip_scale").flip_scale_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


_kernel = None


def fused_flip_scale(
        images: torch.Tensor, masks: Optional[torch.Tensor],
        hflip: torch.Tensor, vflip: torch.Tensor,
        scales: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(float32 images, masks) flipped per sample and scaled.

    images (B,C,H,W) uint8/uint16/int16/float32, masks (B,H,W) integer or
    None, hflip/vflip (B,) bool, scales (B,) float32 (flags and scales may
    lie on the host). CUDA images go through the ``flip_scale`` kernel (one
    launch, counted in ``fused_flip_scale.launches``); CPU images through
    the plain version."""
    global _kernel
    if images.device.type == "cpu":
        return fused_flip_scale_reference(images, masks, hflip, vflip, scales)
    op = "flip_scale"
    if not images.is_cuda:
        raise ValueError(f"{op}: images are on {images.device}, not CUDA")
    if images.dim() != 4 or images.dtype not in _IMAGE_KINDS:
        raise ValueError(f"{op}: need (B,C,H,W) uint8/uint16/int16/float32 "
                         f"images, got {tuple(images.shape)} {images.dtype}")
    if not images.is_contiguous():
        raise ValueError(f"{op}: images are not contiguous")
    b, c, h, w = images.shape
    if masks is not None:
        if masks.device != images.device or not masks.is_contiguous():
            raise ValueError(f"{op}: masks must be contiguous on {images.device}")
        if masks.shape != (b, h, w) or masks.dtype not in _MASK_DTYPES:
            raise ValueError(f"{op}: need ({b},{h},{w}) integer masks, got "
                             f"{tuple(masks.shape)} {masks.dtype}")
    for name, t in (("hflip", hflip), ("vflip", vflip), ("scales", scales)):
        if t.shape != (b,):
            raise ValueError(f"{op}: {name} must have shape ({b},), got {tuple(t.shape)}")
    dev = images.device
    flags = torch.stack([hflip, vflip], dim=1).to(dev, torch.int32).contiguous()
    scales = scales.to(dev, torch.float32).contiguous()
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
    mask_out = None if masks is None else torch.empty_like(masks)
    if _kernel is None:
        _kernel = _load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(images.data_ptr(), out.data_ptr(),
                      None if masks is None else masks.data_ptr(),
                      None if mask_out is None else mask_out.data_ptr(),
                      flags.data_ptr(), scales.data_ptr(),
                      _IMAGE_KINDS[images.dtype],
                      0 if masks is None else masks.element_size(),
                      b, c, h, w, stream)
    if err != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {err}")
    fused_flip_scale.launches += 1
    return out, mask_out


fused_flip_scale.launches = 0
