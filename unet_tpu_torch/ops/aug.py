"""Per-sample flip + value scaling of a training batch, in one pass.

Counterpart of ``unet_tpu/ops/pallas_aug.py``. ``fused_flip_scale(images,
masks, hflip, vflip, scales)`` takes NCHW tiles in their storage dtype
(uint8, uint16, int16 or float32) and (B, H, W) integer masks, flips each
sample horizontally and/or vertically, widens the images to float32 and
multiplies each sample by its scale; the masks come out flipped in their
own dtype. For CUDA tensors it launches the CUDA kernel
``csrc/flip_scale.cu`` (one read and one write per tile, images and masks
in one launch, flags and scales passed by value so that a call makes no
copy) or raises; for CPU tensors it runs the plain version,
``fused_flip_scale_reference``. Both give the bits of
``x.float().flip(...) * scale``.

``pack_flip_params`` and ``launch_blocks`` are the host side of a
launch: the parameter block the kernel takes by value, and its grid. The
launcher picks the kernel's path (words of 4 elements, or one element a
group) from W and the pointers.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from .bn import _sm_count

# These mirror csrc/flip_scale.cu: kMaxB, sizeof(FlipParams) (checked
# against the library), kThreads / 32 and kChunk (32 lanes x kUnroll groups).
MAX_B = 512  # samples per launch
PARAM_BYTES = 2176  # hflip bit words, vflip bit words, MAX_B float32 scales
WARPS_PER_BLOCK = 8
CHUNK = 128  # groups per warp item
BLOCKS_PER_SM = 8

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


def pack_flip_params(hflip: Sequence[bool], vflip: Sequence[bool],
                     scales: Sequence[float]) -> List[Tuple[int, int, bytes]]:
    """The kernel's parameter blocks: ``[(start, stop, block)]``, one for
    each run of up to ``MAX_B`` samples. ``block`` is ``PARAM_BYTES`` bytes:
    16 little-endian uint32 words of hflip bits (sample ``start + i`` is
    bit ``i % 32`` of word ``i // 32``), 16 of vflip bits, then ``MAX_B``
    float32 scales (rounded from float64 once); the unused tail is 0."""
    out = []
    for start in range(0, len(scales), MAX_B):
        stop = min(start + MAX_B, len(scales))
        bits = [sum(1 << i for i, f in enumerate(flags[start:stop]) if f)
                .to_bytes(MAX_B // 8, "little") for flags in (hflip, vflip)]
        out.append((start, stop, b"".join(bits) + struct.pack(
            f"<{stop - start}f", *scales[start:stop]) + bytes(4 * (MAX_B - stop + start))))
    return out


def launch_blocks(b: int, c: int, h: int, w: int, with_mask: bool, sms: int) -> int:
    """Blocks of one launch over ``b`` samples: ``WARPS_PER_BLOCK`` warps,
    one warp per (row, chunk) item, counted at one element a group (the
    element path's count, which bounds the word path's), at most
    ``BLOCKS_PER_SM`` per multiprocessor (the warps then loop over the
    items)."""
    items = b * (c + int(with_mask)) * h * -(-w // CHUNK)
    if items >= 2 ** 31:
        raise ValueError(f"flip_scale: {items} work items exceed the kernel's 32-bit count")
    return max(1, min(-(-items // WARPS_PER_BLOCK), sms * BLOCKS_PER_SM))


def _load_kernel():
    from . import _build

    lib = _build.load("flip_scale")
    if lib.flip_scale_param_bytes() != PARAM_BYTES:
        raise RuntimeError(f"flip_scale: the kernel's parameter block is "
                           f"{lib.flip_scale_param_bytes()} bytes, the host packs {PARAM_BYTES}")
    fn = lib.flip_scale_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


_kernel = None


def fused_flip_scale(
        images: torch.Tensor, masks: Optional[torch.Tensor],
        hflip: torch.Tensor, vflip: torch.Tensor,
        scales: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(float32 images, masks) flipped per sample and scaled.

    images (B,C,H,W) uint8/uint16/int16/float32, masks (B,H,W) integer or
    None, hflip/vflip (B,) bool, scales (B,) float32. CUDA images go
    through the ``flip_scale`` kernel, one launch per ``MAX_B`` samples,
    each counted in ``fused_flip_scale.launches``; CPU images through the
    plain version. The kernel takes flags and scales by value, so they are
    read on the host: host tensors (as the trainer draws them) cost
    nothing, while flags or scales on the card are copied to the host
    once, which waits for the work queued before them."""
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
    params = pack_flip_params(hflip.tolist(), vflip.tolist(),
                              scales.detach().to(torch.float32).tolist())
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
    mask_out = None if masks is None else torch.empty_like(masks)
    if out.numel() == 0:
        return out, mask_out
    if _kernel is None:
        _kernel = _load_kernel()
    sms = _sm_count(dev)
    # (tensor, bytes per sample) of each operand; a launch starts at its first sample
    operands = [(images, c * h * w * images.element_size()), (out, c * h * w * 4)]
    if masks is not None:
        operands += [(t, h * w * masks.element_size()) for t in (masks, mask_out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for start, stop, block in params:
            ptrs = [t.data_ptr() + start * step for t, step in operands]
            if masks is None:
                ptrs += [None, None]
            err = _kernel(*ptrs, block, _IMAGE_KINDS[images.dtype],
                          0 if masks is None else masks.element_size(), stop - start,
                          c, h, w, launch_blocks(stop - start, c, h, w, masks is not None, sms),
                          stream)
            if err != 0:
                raise RuntimeError(f"{op} launch failed: CUDA error {err}")
            fused_flip_scale.launches += 1
    return out, mask_out


fused_flip_scale.launches = 0
