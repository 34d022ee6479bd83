"""On-device overlap-blend mosaic accumulation for whole-scene serving.

Counterpart of ``unet_tpu/ops/blend.py``. The mosaic's probability sum
(C, H, W) and overlap counter (H, W) stay in device memory; each predicted
batch is scatter-added at its window offsets, the finalize (divide, argmax
or select) runs there too, and only the finished output crosses to the
host.

* ``blend_and_count`` — binding of the CUDA kernel ``csrc/blend_count.cu``
  (one launch per batch, bit-identical to the sequential loop). CUDA
  tensors only; anything else raises.
* ``blend_and_count_reference`` — the plain PyTorch version: the
  sequential loop itself. The CPU path and the tests use it.
* ``DeviceMosaic`` — the accumulator of a whole scene: on ``cuda`` it
  calls the kernel, on ``cpu`` the plain version.
* ``DeviceBand`` — the same over a band of rows that moves down the scene,
  for scenes of any size: the sums stay O(band) on the device.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def _host_offsets(rows, cols, n: int) -> Tuple[np.ndarray, np.ndarray]:
    rows = np.asarray(rows, np.int64).reshape(-1)
    cols = np.asarray(cols, np.int64).reshape(-1)
    if rows.shape != (n,) or cols.shape != (n,):
        raise ValueError(f"need {n} rows and cols, got {rows.shape} and {cols.shape}")
    return rows, cols


def _check_offsets(rows: np.ndarray, cols: np.ndarray, h: int, w: int,
                   th: int, tw: int) -> None:
    if rows.size and (rows.min() < 0 or rows.max() > h - th
                      or cols.min() < 0 or cols.max() > w - tw):
        raise ValueError(
            f"tile offsets out of range: a {th}x{tw} tile needs 0 <= row <= "
            f"{h - th} and 0 <= col <= {w - tw}")


def blend_and_count_reference(mosaic: torch.Tensor, count: torch.Tensor,
                              tiles: torch.Tensor, rows, cols) -> None:
    """In place, in tile order: ``mosaic[:, r:r+th, c:c+tw] += tiles[i]``
    and ``count[r:r+th, c:c+tw] += 1``. ``rows``/``cols`` are host ints."""
    n, _, th, tw = tiles.shape
    rows, cols = _host_offsets(rows, cols, n)
    _check_offsets(rows, cols, mosaic.shape[1], mosaic.shape[2], th, tw)
    for i, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        mosaic[:, r:r + th, c:c + tw] += tiles[i]
        count[r:r + th, c:c + tw] += 1.0


def _load_kernel():
    from . import _build

    lib = _build.load("blend_count")
    fn = lib.blend_count_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


_kernel = None


def blend_and_count(mosaic: torch.Tensor, count: torch.Tensor,
                    tiles: torch.Tensor, rows, cols) -> None:
    """The CUDA kernel ``blend_count``: the same in-place update as
    ``blend_and_count_reference``, in one launch on the current stream.

    mosaic (C,H,W) f32, count (H,W) f32, tiles (N,C,th,tw) f32 — all
    contiguous and on one CUDA device; rows/cols (N,) host ints with
    0 <= r <= H-th and 0 <= c <= W-tw. Raises ``ValueError`` otherwise.
    """
    global _kernel
    for name, t in (("mosaic", mosaic), ("count", count), ("tiles", tiles)):
        if not t.is_cuda:
            raise ValueError(f"blend_count: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise ValueError(f"blend_count: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"blend_count: {name} is not contiguous")
        if t.device != mosaic.device:
            raise ValueError("blend_count: tensors on different devices")
    if mosaic.dim() != 3 or tiles.dim() != 4 or count.shape != mosaic.shape[1:] \
            or tiles.shape[1] != mosaic.shape[0]:
        raise ValueError(f"blend_count: shapes mosaic {tuple(mosaic.shape)}, "
                         f"count {tuple(count.shape)}, tiles {tuple(tiles.shape)}")
    n, c, th, tw = tiles.shape
    _, h, w = mosaic.shape
    rows, cols = _host_offsets(rows, cols, n)
    _check_offsets(rows, cols, h, w, th, tw)
    if n == 0:
        return
    if _kernel is None:
        _kernel = _load_kernel()
    y0, x0 = int(rows.min()), int(cols.min())
    bh, bw = int(rows.max()) + th - y0, int(cols.max()) + tw - x0
    rowcol = torch.from_numpy(np.concatenate([rows, cols]).astype(np.int32)) \
        .to(mosaic.device)
    with torch.cuda.device(mosaic.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(mosaic.data_ptr(), count.data_ptr(), tiles.data_ptr(),
                      rowcol.data_ptr(), n, c, h, w, th, tw, y0, x0, bh, bw,
                      stream)
    if err != 0:
        raise RuntimeError(f"blend_count launch failed: CUDA error {err}")
    blend_and_count.launches += 1


blend_and_count.launches = 0


def mosaic_bytes(height: int, width: int, n_classes: int) -> int:
    """Bytes of a float32 sum (C,H,W) plus count (H,W) mosaic."""
    return height * width * (n_classes + 1) * 4


def free_device_bytes(device: torch.device) -> int:
    """Bytes a new tensor can take on ``device``: the card's free memory
    plus what PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _default_blend(device: torch.device) -> Callable:
    """The kernel on ``cuda``, the plain version on ``cpu``."""
    return blend_and_count if device.type == "cuda" else blend_and_count_reference


def check_mosaic_fits(nbytes: int, free_bytes: int) -> None:
    """Raise ``RuntimeError`` when a whole-scene mosaic exceeds the card's
    free memory. Only ``save_predictions --device-merge`` needs the whole
    mosaic on the card; serving picks the banded mosaic instead, and the
    sums never move to the host."""
    if nbytes > free_bytes:
        raise RuntimeError(
            f"mosaic needs {nbytes / 1e9:.1f} GB, the card has "
            f"{free_bytes / 1e9:.1f} GB free; merge on the host instead "
            "(predict --merge without --device-merge)")


class DeviceMosaic:
    """Device-resident sum + count mosaic for whole-scene prediction.

    ``blend`` defaults to the kernel on ``cuda`` and the plain version on
    ``cpu``; passing ``blend_and_count_reference`` on ``cuda`` runs the plain
    version there (for comparing the two)."""

    def __init__(self, height: int, width: int, n_classes: int,
                 device="cuda", blend: Optional[Callable] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_mosaic_fits(mosaic_bytes(height, width, n_classes),
                              free_device_bytes(self.device))
        self.height, self.width, self.n_classes = height, width, n_classes
        self.sum = torch.zeros((n_classes, height, width), dtype=torch.float32,
                               device=self.device)
        self.count = torch.zeros((height, width), dtype=torch.float32,
                                 device=self.device)
        self.blend = blend or _default_blend(self.device)

    def add_batch(self, probs: torch.Tensor, rows, cols) -> None:
        """probs: (N, C, th, tw) on the mosaic's device; rows/cols host
        offsets."""
        if probs.shape[1] != self.n_classes:
            raise ValueError(f"probs have {probs.shape[1]} classes, mosaic "
                             f"{self.n_classes}")
        self.blend(self.sum, self.count,
                   probs.to(torch.float32).contiguous(), rows, cols)

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(summed (C,H,W), counter (H,W)) on the host: the input of the
        host ``finalize_mosaic``, for comparing it with ``finish``."""
        summed = self.sum[:, :self.height, :self.width].cpu().numpy()
        counter = self.count[:self.height, :self.width].cpu().numpy()
        return summed, counter

    def finish(self, **mode) -> Tuple[torch.Tensor, Optional[float]]:
        """(output, nodata) of ``finalize_mosaic_torch`` on the mosaic, on
        its device; ``mode``: ``regression``, ``all_classes``,
        ``specific_class``."""
        from ..predict.merge import finalize_mosaic_torch

        return finalize_mosaic_torch(self.sum, self.count, **mode)


class DeviceBand:
    """Sum + count of the scene rows [top, top + rows) on the device: the
    mosaic of a scene of any size, one band of rows at a time.

    ``add_batch`` takes scene rows; every window must lie inside the band.
    ``finalize_rows(upto)`` finalizes the rows [top, upto) on the device,
    returns them, and moves the rest of the band up so that ``upto`` becomes
    its top. The move goes into a second buffer and the two swap: PyTorch
    refuses a copy between overlapping slices of one tensor, and a clone
    per move would allocate the band anew each time."""

    def __init__(self, rows: int, width: int, n_classes: int, device="cuda",
                 blend: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.rows, self.width, self.n_classes = rows, width, n_classes
        self.top = 0
        self._buffers = [
            (torch.zeros((n_classes, rows, width), dtype=torch.float32, device=self.device),
             torch.zeros((rows, width), dtype=torch.float32, device=self.device))
            for _ in range(2)]
        self.sum, self.count = self._buffers[0]
        self.blend = blend or _default_blend(self.device)

    def add_batch(self, probs: torch.Tensor, rows, cols) -> None:
        """probs: (N, C, th, tw) on the band's device; rows (scene rows) and
        cols host offsets."""
        if probs.shape[1] != self.n_classes:
            raise ValueError(f"probs have {probs.shape[1]} classes, band "
                             f"{self.n_classes}")
        rows = np.asarray(rows, np.int64) - self.top
        self.blend(self.sum, self.count, probs.to(torch.float32).contiguous(),
                   rows, cols)

    def finalize_rows(self, upto: int, **mode) -> Tuple[torch.Tensor, Optional[float]]:
        """(output, nodata) of ``finalize_mosaic_torch`` on the scene rows
        [top, upto), on the device; then ``upto`` is the band's top."""
        from ..predict.merge import finalize_mosaic_torch

        n = upto - self.top
        if not 0 < n <= self.rows:
            raise ValueError(f"cannot finalize rows {self.top}..{upto} of a "
                             f"{self.rows}-row band at row {self.top}")
        out = finalize_mosaic_torch(self.sum[:, :n], self.count[:n], **mode)
        i = 1 if self.sum is self._buffers[0][0] else 0
        nxt_sum, nxt_count = self._buffers[i]
        keep = self.rows - n
        nxt_sum[:, :keep].copy_(self.sum[:, n:])
        nxt_sum[:, keep:].zero_()
        nxt_count[:keep].copy_(self.count[n:])
        nxt_count[keep:].zero_()
        self.sum, self.count = nxt_sum, nxt_count
        self.top = upto
        return out
