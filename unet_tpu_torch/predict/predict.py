"""Batched prediction with georeferenced outputs: whole scenes and tile sets.

Counterpart of ``unet_tpu/predict/predict.py``. Rasters stay in their
storage dtype on the host; each batch crosses to the device in that dtype
and in the byte order it has on the host (through pinned memory on the
card, without waiting for earlier work), is made a contiguous
(B, H, W, C) tile and scaled there, and runs through the U-Net in the
compute dtype (bf16 on the card).

* ``predict_raster`` (``serve``): sliding windows over one scene of any
  size, the overlap sums added on the device by the ``blend_count`` CUDA
  kernel and finalized there; only the finished output comes back to the
  host. It picks one of three tiers, as the JAX package does:
  a whole-scene ``DeviceMosaic`` while the mosaic fits
  ``device_budget_bytes`` and the card's free memory; else a
  ``DeviceBand`` of rows that moves down the scene held in RAM
  (``_serve_banded``); else, past ``host_budget_bytes``,
  ``predict_raster_streamed``: the same band over windowed reads, the
  finished rows streamed to the output GeoTIFF, O(band) memory.
* ``save_predictions`` (``predict``): every tile file of a folder, written
  back as predicted tiles or merged into an overlap-averaged mosaic, on the
  host (``MosaicAccumulator``) or on the card (``device_merge``, the
  ``blend_count`` kernel, finalized on the card).

Each takes ``predictor=``: a resident ``Predictor`` (a bundle) or an
``artifact.ArtifactPredictor`` (a frozen ``.uta`` serving artifact, the
same surface; the manifest fields they read come from its header).

``spatial`` = S > 1 (JAX's ``space`` mesh axis; ``parallel/halo.py``):
the ``Predictor`` runs in a process group of exactly S ranks
(``parallel.mesh.launch`` starts them for the command line), one space
group. Every rank reads and stacks the same batches; each forward takes
this rank's rows of the whole windows (TTA flips whole windows first and
unflips after), and the probabilities' rows are gathered to rank 0, which
alone adds them into the mosaic (``blend_count``), finalizes and writes,
on every tier; the other ranks run the forwards only (``_forwards_only``)
and their forwards return None. The window or tile height must be
divisible by 32·S, checked before any compute.

Every host phase of a served scene is a ``StepTimer`` phase
(``utils/profiling.py``) of ``predictor.timer``, a new timer each scene,
and the scene's record sums them in ``host_s``: ``serve.read`` (the
scene, or on the streamed tier each window of rows), ``serve.plan``
(header, tier, windows, the mosaic or band), ``serve.stack`` (a batch's
windows gathered into a pinned host block in their own byte order,
planar for a CHW scene, ``host_batch``, the last batch padded in place),
``serve.h2d`` (the block's copy queued and, for a planar block, its
interleave to (B, H, W, C) issued on the device, ``stage_batch``),
``serve.forward`` (issuing the forward and ``finish_probs``),
``serve.add`` (the batch's ``blend_count`` adds), ``serve.finalize``
(finalize and fetch queued), ``serve.fetch`` (the host's wait on the
fetch), ``serve.write`` (the output) and, where a thread builds the
batches ahead, ``serve.wait`` (the loop's wait on it). No phase encloses
another, so under a profiler the card's idle time is named by the one
phase the host is in.

Output modes: argmax class map (uint8, default), ``all_classes``
(float32 stack), ``specific_class`` (float32 band), ``regression``
(float32 values, nodata −9999 in a mosaic), ``large_file`` (tiles:
probabilities stretched to int8 ×31; a host mosaic: int8 sums),
``class_zero`` (0 → nodata, classes decremented on write).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import image_scale
from ..geo import read_raster, tiff, write_raster
from ..models.layers import pixel_shuffle
from ..models.unet import check_spatial_height
from ..ops.blend import DeviceBand, DeviceMosaic, free_device_bytes, mosaic_bytes
from ..parallel import halo, mesh
from ..tiling.windows import Window, generate_windows
from ..train.checkpoint import load_bundle
from ..utils.device import resolve_device
from ..utils.profiling import DeviceSpans, StepTimer
from ..utils.progress import TileProgress
from .figures import plot_valid_predict
from .merge import MosaicAccumulator, grid_layout, tile_extent_info

READ_AHEAD = 2  # batches of scene rows read and stacked ahead of the forward


def _apply_class_zero(arr: np.ndarray, nodata: Optional[float]) -> np.ndarray:
    """0 → nodata, other classes decremented (reference predict.py:32-35)."""
    fill = nodata if nodata is not None else 0
    return np.where(arr == 0, fill, arr - 1)


def make_probs_fn(model, regression: bool):
    """``fn(x)`` mapping a scaled (B,C,H,W) batch to (B,n_out,H,W)
    probabilities, or (B,1,H,W) values in regression mode.

    The branch follows the logits' shape, as in the JAX package. A tpu_opt
    model returns the sub-pixel head's folded logits: the softmax runs in
    that layout — (B, n_out·4, H/2, W/2) viewed as (B, n_out, 4, H/2, W/2),
    over the class axis — and one pixel shuffle of finished probabilities
    follows; per pixel it reduces over the same values as a
    full-resolution softmax. A parity model returns full-resolution logits
    (B, n_out, H, W): the softmax runs over the classes as they are."""

    def probs_fn(x: torch.Tensor) -> torch.Tensor:
        logits = model(x, fold_logits=True)
        if logits.shape[-1] == x.shape[-1]:
            return logits[:, 0:1] if regression else torch.softmax(logits, dim=1)
        b, crr, h2, w2 = logits.shape
        if regression:
            return pixel_shuffle(logits, 2)[:, 0:1]
        ps = torch.softmax(logits.view(b, crr // 4, 4, h2, w2), dim=1)
        return pixel_shuffle(ps.view(b, crr, h2, w2), 2)

    return probs_fn


def spatial_probs_fn(probs_fn, scope: halo.SpaceScope):
    """``probs_fn`` on this rank's rows of whole (B,C,H,W) windows, under
    the space scope; returns the whole windows' probabilities, every
    rank's rows gathered, on the space group's rank 0, and None on the
    other ranks."""

    def fn(x: torch.Tensor) -> Optional[torch.Tensor]:
        with halo.space_scope(scope):
            local = probs_fn(halo.split_rows(x, 2, scope))
        return halo.gather_rows_to_first(local, 2, scope)

    return fn


def tta_probs_fn(probs_fn):
    """4-fold flip test-time augmentation: the mean of the probabilities
    over {identity, hflip, vflip, hvflip} (None where ``probs_fn`` gives
    None: a spatial rank other than 0)."""

    def fn(x: torch.Tensor) -> Optional[torch.Tensor]:
        acc = probs_fn(x)
        for dims in ((3,), (2,), (2, 3)):
            probs = probs_fn(torch.flip(x, dims))
            if acc is not None:
                acc = acc + torch.flip(probs, dims)
        return None if acc is None else acc / 4

    return fn


def finish_probs(probs: torch.Tensor, folded: bool = False,
                 quantize_int8: bool = False,
                 argmax_u8: bool = False) -> torch.Tensor:
    """Post-ops on (B,C,H,W) probabilities, on the device.

    ``argmax_u8``: (B,H,W) uint8 class map (first index wins on ties, as
    ``np.argmax``). ``quantize_int8``: the reference's ``large_file``
    stretch ×31 with round-half-even, to int8. ``folded``: the JAX
    package's (B, H, W·C) channels-last layout."""
    if argmax_u8:
        return torch.argmax(probs, dim=1).to(torch.uint8)
    if quantize_int8:
        probs = torch.round(probs * ((128 / 4) - 1)).to(torch.int8)
    if folded:
        b, c, h, w = probs.shape
        probs = probs.permute(0, 2, 3, 1).reshape(b, h, w * c)
    return probs


def host_batch(tiles: Sequence[np.ndarray], size: int, device: torch.device) -> np.ndarray:
    """``tiles`` ((H, W, C) windows of a scene, at most ``size``) gathered
    into a new (B, H, W, C) host block in the windows' own byte order,
    pinned where ``device`` is a card (PyTorch's caching host allocator):
    windows of a CHW scene (the channel their largest stride) go into the
    (B, H, W, C) view of a (B, C, H, W) block, any other into a contiguous
    one, so ``np.stack`` copies whole rows either way. Rows past the tiles
    repeat the last, padding a short batch. ``predict_batch_device`` sends
    the block across as it is."""
    h, w, c = tiles[0].shape
    block = torch.empty(size * c * h * w * tiles[0].itemsize, dtype=torch.uint8,
                        pin_memory=device.type == "cuda").numpy().view(tiles[0].dtype)
    if tiles[0].strides[2] == max(tiles[0].strides):
        batch = block.reshape(size, c, h, w).transpose(0, 2, 3, 1)
    else:
        batch = block.reshape(size, h, w, c)
    np.stack(tiles, out=batch[:len(tiles)])
    batch[len(tiles):] = batch[len(tiles) - 1]
    return batch


def stage_batch(images, device: torch.device) -> torch.Tensor:
    """The host tensor a (B, H, W, C) batch (numpy or a CPU tensor) crosses
    to ``device`` from, in the batch's own byte order: the host reorders no
    byte. On the card a pinned batch (a ``host_batch`` block or a tensor)
    crosses as it is; any other is copied once with ``np.copyto`` (a
    straight memcpy for a dense batch) into a pinned block of its strides
    from PyTorch's caching host allocator, which hands a block out again
    only after the copy that read it has finished. Elsewhere the batch
    itself."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        images if min(images.strides, default=0) >= 0 else np.ascontiguousarray(images))
    if device.type != "cuda" or x.is_pinned():
        return x
    block = torch.empty_like(x, pin_memory=True)  # a dense batch's strides kept
    np.copyto(block.numpy(), x.numpy())
    return block


class BatchPredictor:
    """The batch surface every prediction path takes through ``predictor=``:
    ``predict_batch_device`` (tiles to the device in their storage dtype,
    through pinned memory on the card, each forward timed by
    ``DeviceSpans``), ``predict_batch`` and ``forward_ms``. A subclass sets
    ``device``, ``_forwards`` and ``timer`` (the host phases, ``StepTimer``)
    and computes (B, n_out, H, W) probabilities of the raw (B, H, W, C)
    device tiles in ``_forward``. ``planar_batches`` counts the batches
    that crossed in another byte order than (B, H, W, C) and were
    interleaved on the device."""

    device: torch.device
    _forwards: DeviceSpans
    timer: StepTimer
    space: Optional[halo.SpaceScope] = None  # spatial partitioning: the space group
    primary = True  # the rank that adds, finalizes and writes
    planar_batches = 0

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.inference_mode()
    def predict_batch_device(self, images,
                             quantize_int8: bool = False,
                             argmax_u8: bool = False) -> Optional[torch.Tensor]:
        """(B,H,W,C) raw tile values (numpy, any strides, or a CPU tensor)
        → device (B,n_out,H,W) probabilities (or the finished forms of
        ``finish_probs``; None on a spatial rank other than 0). Tiles cross
        to the device in their storage dtype and their host byte order
        (``stage_batch``); in ``serve.h2d`` the copy is queued and the
        interleave to the contiguous (B,H,W,C) tile ``_forward`` takes is
        issued on the device, outside the forward's span; the float cast
        and scaling run there too."""
        with self.timer.phase("serve.h2d"):
            x = stage_batch(images, self.device)
            if not x.is_contiguous():
                self.planar_batches += 1
            # from pinned memory the copy is queued behind earlier work
            # instead of waiting for it, as a pageable copy does; the same
            # dense strides on both sides make it one memcpy
            x = x.to(self.device, non_blocking=True).contiguous()
        with self.timer.phase("serve.forward"):
            self._forwards.start()
            out = self._forward(x)
            if out is not None:
                out = finish_probs(out, quantize_int8=quantize_int8, argmax_u8=argmax_u8)
            self._forwards.stop()
        return out

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """(B,H,W,C) → host (B,H,W,n_out) probabilities (the JAX
        package's layout)."""
        return self.predict_batch_device(images).permute(0, 2, 3, 1).cpu().numpy()

    def forward_ms(self) -> List[float]:
        """Milliseconds of every forward so far (device time on CUDA)."""
        return self._forwards.ms()


class Predictor(BatchPredictor):
    """Loads a bundle onto ``device`` and predicts batches of equally sized
    tiles. ``dtype`` is the compute dtype (bf16 on the card).

    ``scenes`` holds one record a served scene (``predict_raster``,
    ``predict_raster_streamed``): the tier taken, windows, batches, the
    mosaic's adds (``blend_count`` launches on the card), the band's rows
    and its batches that span two window rows, the finalize's seconds
    (device time on the card), the host's seconds reading the scene and
    writing the output, the scene's seconds, ``planar_batches`` (its
    batches interleaved on the device, ``BatchPredictor``) and ``host_s``:
    the host seconds of each of the serve loop's phases (``serve.*``),
    summed over the scene. ``timer`` holds the phases of the scene being
    served (the last one after it).

    ``spatial`` = S > 1: this process is one of a process group of
    exactly S ranks (``ValueError``, naming ``parallel.mesh.launch``,
    otherwise); its device is ``cuda:{rank % cards}`` where ``device``
    says ``cuda``."""

    def __init__(self, bundle: str, batch_size: int = 16, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, tta: bool = False,
                 spatial: int = 1):
        self.device = resolve_device(device)
        if int(spatial) > 1:
            self.space = mesh.space_layout(spatial)
            if mesh.data_size() != 1:
                raise ValueError(f"Predictor(spatial={spatial}) runs in a process group of "
                                 f"exactly {spatial} ranks, not {mesh.data_size() * spatial}")
            self.primary = self.space.rank == 0
            self.device = mesh.rank_device(device)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        self.tta = bool(tta)
        self.dtype = dtype
        self.model, self.manifest = load_bundle(bundle, dtype=dtype)
        self.model.to(self.device)
        self.regression = bool(self.manifest.get("enable_regression", False))
        self.dtype_str = self.manifest.get("dtype_str", "int8")
        self.normalize = self.manifest.get("normalize", "reference")
        self.scale = image_scale(self.dtype_str, self.normalize)
        self.batch_size = batch_size
        probs_fn = make_probs_fn(self.model, self.regression)
        if self.space is not None:
            probs_fn = spatial_probs_fn(probs_fn, self.space)
        self.probs_fn = tta_probs_fn(probs_fn) if self.tta else probs_fn
        self._forwards = DeviceSpans(self.device)
        self.timer = StepTimer()
        self.scenes: List[dict] = []

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.probs_fn(x.permute(0, 3, 1, 2).to(torch.float32) * self.scale)


def _check_spatial(predictor: BatchPredictor, spatial: int, height: int) -> None:
    """Before any compute: a ``spatial`` > 1 call needs a predictor made
    with it, and windows or tiles of ``height`` rows that split into its
    ranks' rows (``check_spatial_height``)."""
    space = predictor.space
    if int(spatial) > 1 and (space is None or space.size != int(spatial)):
        raise ValueError(f"spatial={spatial} needs a Predictor made with spatial={spatial}")
    if space is not None:
        check_spatial_height(predictor.model.arch, height, space.size)


def _forwards_only(predictor: BatchPredictor, batches) -> bool:
    """On a spatial rank other than 0: run the forwards of ``batches``
    (host batches, the same as rank 0's, which gathers their rows) and
    return True. False, with nothing run, on rank 0 or without spatial
    partitioning."""
    if predictor.primary:
        return False
    for batch in batches:
        predictor.predict_batch_device(batch)
    return True


def _read_ahead(batches: Sequence, load: Callable, timer: StepTimer):
    """``load(b)`` of each of ``batches`` in order, each read on a thread
    ``READ_AHEAD`` batches ahead of the caller; the caller's wait for each
    is the phase ``serve.wait``."""
    with cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="rows") as pool:
        reads = deque(pool.submit(load, b) for b in batches[:READ_AHEAD])
        for k in range(len(batches)):
            with timer.phase("serve.wait"):
                batch = reads.popleft().result()
            if k + READ_AHEAD < len(batches):
                reads.append(pool.submit(load, batches[k + READ_AHEAD]))
            yield batch


def _check_out_compress(out_compress, regression=False, all_classes=False,
                        specific_class=None, large_file=False) -> None:
    """JPEG output codecs only fit uint8 class maps; fail before compute."""
    if out_compress not in ("jpeg", "jpeg-lossless"):
        return
    wrong = [name for flag, name in (
        (regression, "regression (float32 output)"),
        (all_classes, "all_classes (float32 output)"),
        (specific_class is not None, "specific_class (float32 output)"),
        (large_file, "large_file (int8 output)")) if flag]
    if wrong:
        raise ValueError(
            f"out_compress={out_compress!r} requires uint8 class-map "
            f"output, incompatible with: {', '.join(wrong)} — use "
            "'deflate'/'lzw'/'packbits' for those modes")


def _fetch(out: torch.Tensor):
    """Start ``out``'s copy to the host: on the card into pinned memory,
    queued behind the forward, with an event recorded after it; on the CPU
    the tensor itself. Returns (host tensor, event or None)."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def band_plan(windows: Sequence[Window], batch_size: int) -> Tuple[List[list], int]:
    """(batches, band rows) of the banded serve: the windows sorted by
    (y, x), as the JAX package's streamed path walks them, cut into batches
    of ``batch_size`` that run on across window rows (only the last batch
    is short), and the rows a band needs to hold every window of any one
    batch."""
    order = sorted(windows, key=lambda win: (win.y, win.x))
    batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
    rows = max(b[-1].y + b[-1].h - b[0].y for b in batches)
    return batches, rows


class WindowedRows:
    """``rows(r0, r1)``: the scene rows [r0, r1) of a GeoTIFF as (rows, W, C)
    in its storage dtype, read with ``tiff.read_window`` for a caller that
    walks down the scene (r0 and r1 never decrease). Rows stay on the host
    until a later call's r0 passes them, each row is decoded once, and
    decoded segments above the read front are evicted: memory is
    O(rows held), never the scene."""

    def __init__(self, path: str):
        self.path = path
        self._cache: dict = {}
        self._rows = None
        self._first = 0

    def __call__(self, r0: int, r1: int) -> np.ndarray:
        end = self._first + (0 if self._rows is None else len(self._rows))
        if self._rows is None or r0 >= end:
            chw, _ = tiff.read_window(self.path, r0, r1, _cache=self._cache)
            self._rows, self._first = np.moveaxis(chw, 0, 2), r0
        elif r1 > end:
            chw, _ = tiff.read_window(self.path, end, r1, _cache=self._cache)
            self._rows = np.concatenate([self._rows[r0 - self._first:],
                                         np.moveaxis(chw, 0, 2)])
            self._first = r0
        tiff.evict_decoded_rows(self._cache, r1)
        return self._rows[r0 - self._first:r1 - self._first]

    def close(self) -> None:
        f = self._cache.get("f")
        if f is not None:
            f.close()


def _serve_banded(predictor: Predictor, height: int, width: int, patch: int,
                  patch_overlap: float, read_rows: Callable, emit: Callable,
                  mode: dict, record: dict) -> Optional[float]:
    """The banded serve, shared by the in-RAM and the streamed tier.

    Windows in (y, x) order go through the model in batches of
    ``predictor.batch_size`` (``band_plan``) and are added into a
    ``DeviceBand`` (the ``blend_count`` kernel on the card), one add for
    each window row of a batch: a batch that wraps from one window row to
    the next would give the kernel a bounding box as wide as the scene, and
    at 20000² on an H100 that one launch takes 2.3× a batch within a row
    while the two parts together take less than one (PERF.md §6); the adds
    keep the tiles' order, so the sums are the same. After each
    batch the rows above the next window not yet added are final: they are
    finalized on the device, copied to pinned host memory behind an event,
    and handed to ``emit`` as a numpy array ((n, W), or (C, n, W) for
    ``all_classes``) once the next finalize is queued. ``read_rows(r0, r1)``
    gives scene rows as (rows, W, C); a thread calls it and gathers each
    batch into a ``host_batch`` block ``READ_AHEAD`` batches ahead of the
    forward. Fills ``record``; returns the output's nodata (None on a
    spatial rank other than 0, ``_forwards_only``)."""
    timer = predictor.timer
    with timer.phase("serve.plan"):
        windows = generate_windows(height, width, patch, patch_overlap)
        bs = predictor.batch_size
        batches, band_rows = band_plan(windows, bs)
        record.update(windows=len(windows), batches=len(batches), band_rows=band_rows,
                      wrapping_batches=sum(b[0].y != b[-1].y for b in batches),
                      adds=sum(len({win.y for win in b}) for b in batches))

    def load(chunk):
        r0 = chunk[0].y
        rows = read_rows(r0, chunk[-1].y + chunk[-1].h)
        with timer.phase("serve.stack"):
            return host_batch([rows[win.y - r0:win.y - r0 + win.h, win.x:win.x + win.w]
                               for win in chunk], bs, predictor.device)

    if _forwards_only(predictor, _read_ahead(batches, load, timer)):
        return None
    with timer.phase("serve.plan"):
        n_out = int(predictor.manifest.get("n_out", 2))
        band = DeviceBand(band_rows, width, n_out, device=predictor.device)
    finalize = DeviceSpans(predictor.device)
    pending: deque = deque()  # (host tensor, event) of finalized rows

    def drain(keep: int) -> None:
        while len(pending) > keep:
            host, event = pending.popleft()
            with timer.phase("serve.fetch"):
                if event is not None:
                    event.synchronize()
                rows = host.numpy()
            with timer.phase("serve.write"):
                emit(rows)

    nodata = None
    for k, (batch, chunk) in enumerate(zip(_read_ahead(batches, load, timer), batches)):
        probs = predictor.predict_batch_device(batch)[:len(chunk)]
        with timer.phase("serve.add"):
            start = 0
            for end in range(1, len(chunk) + 1):
                if end == len(chunk) or chunk[end].y != chunk[start].y:
                    band.add_batch(probs[start:end], [chunk[start].y] * (end - start),
                                   [win.x for win in chunk[start:end]])
                    start = end
        upto = batches[k + 1][0].y if k + 1 < len(batches) else height
        if upto > band.top:
            with timer.phase("serve.finalize"):
                finalize.start()
                out, nodata = band.finalize_rows(upto, **mode)
                pending.append(_fetch(out))
                finalize.stop()
            drain(1)
    drain(0)
    record["finalize_s"] = sum(finalize.ms()) / 1e3
    return nodata


def _serve_full(predictor: Predictor, hwc: np.ndarray, patch: int,
                patch_overlap: float, mode: dict, record: dict):
    """The whole-scene tier: windows in ``generate_windows``' order, in
    batches of ``predictor.batch_size`` (each gathered into a ``host_batch``
    block, the last padded by repeating its final window), into one
    ``DeviceMosaic``, finalized on the device. Returns (output, nodata) on
    the host; (None, None) on a spatial rank other than 0
    (``_forwards_only``)."""
    timer = predictor.timer
    with timer.phase("serve.plan"):
        h, w = hwc.shape[:2]
        windows = generate_windows(h, w, patch, patch_overlap)
        bs = predictor.batch_size
        chunks = [windows[start:start + bs] for start in range(0, len(windows), bs)]
        record.update(windows=len(windows), batches=len(chunks), adds=len(chunks))

    def batch_of(chunk):
        with timer.phase("serve.stack"):
            return host_batch([hwc[win.indices()] for win in chunk], bs, predictor.device)

    if _forwards_only(predictor, map(batch_of, chunks)):
        return None, None
    with timer.phase("serve.plan"):
        n_out = int(predictor.manifest.get("n_out", 2))
        mosaic = DeviceMosaic(h, w, n_out, device=predictor.device)
    for chunk in chunks:
        probs = predictor.predict_batch_device(batch_of(chunk))[:len(chunk)]
        with timer.phase("serve.add"):
            mosaic.add_batch(probs, [win.y for win in chunk], [win.x for win in chunk])
    finalize = DeviceSpans(predictor.device)
    with timer.phase("serve.finalize"):
        finalize.start()
        out, nodata = mosaic.finish(**mode)
        host, event = _fetch(out)
        finalize.stop()
    with timer.phase("serve.fetch"):
        if event is not None:
            event.synchronize()
        out = host.numpy()
    record["finalize_s"] = sum(finalize.ms()) / 1e3
    return out, nodata


def predict_raster_streamed(
    predict_model: str,
    raster_path: str,
    output_path: str,
    patch_size: Optional[int] = None,
    patch_overlap: float = 0.2,
    batch_size: int = 16,
    regression: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
    class_zero: bool = False,
    spatial: int = 1,
    tta: bool = False,
    predictor: Optional[Predictor] = None,
    out_compress: Optional[str] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> str:
    """Whole-scene prediction at any size in O(band) memory.

    Neither the scene nor the mosaic is ever held whole: scene rows are
    read in windows (``tiff.read_window``, on a thread ahead of the
    forward), the overlap sums accumulate on the device in a band of rows
    (``DeviceBand``, the ``blend_count`` kernel on the card) that is
    finalized there, and the finished rows stream to the output GeoTIFF
    (``tiff.StripStreamWriter``: data first, IFD at close). Returns
    ``output_path``; under ``spatial`` rank 0 alone writes it."""
    _check_out_compress(out_compress, regression, all_classes, specific_class)
    if predictor is None:
        predictor = Predictor(predict_model, batch_size=batch_size, device=device,
                              dtype=dtype, tta=tta, spatial=spatial)
    regression = predictor.regression or regression
    timer = predictor.timer = StepTimer()
    t0, planar0 = time.perf_counter(), predictor.planar_batches
    with timer.phase("serve.plan"):
        info = tiff.read_info(raster_path)
        patch = int(patch_size or predictor.manifest.get("patch_size", 400))
        _check_spatial(predictor, spatial, patch)
        n_out = int(predictor.manifest.get("n_out", 2))
        if regression or all_classes:
            out_bands, out_dtype, nodata = (n_out if all_classes else 1), np.float32, -9999.0
        elif specific_class is not None:
            out_bands, out_dtype, nodata = 1, np.float32, None
        else:
            out_bands, out_dtype, nodata = 1, np.uint8, None
        record = {"raster": str(raster_path), "tier": "streamed", "write_s": 0.0}
        predictor.scenes.append(record)
        rows = WindowedRows(str(raster_path))

    def read_rows(r0: int, r1: int) -> np.ndarray:
        with timer.phase("serve.read"):
            return rows(r0, r1)

    def emit(out: np.ndarray) -> None:
        t1 = time.perf_counter()
        if out.ndim == 2:
            out = out[None]
        if class_zero:
            out = _apply_class_zero(out, nodata)
        writer.append_rows(out.astype(out_dtype, copy=False))
        record["write_s"] += time.perf_counter() - t1

    try:
        with (tiff.StripStreamWriter(
                str(output_path), info.height, info.width, out_bands, out_dtype,
                transform=info.transform, crs=info.crs, nodata=nodata,
                compress=out_compress) if predictor.primary
              else contextlib.nullcontext()) as writer:
            _serve_banded(predictor, info.height, info.width, patch, patch_overlap,
                          read_rows, emit, dict(regression=regression, all_classes=all_classes,
                                                specific_class=specific_class), record)
            if writer is not None:
                with timer.phase("serve.write"):
                    writer.close()  # the IFD, after the rows
    finally:
        rows.close()
    record["planar_batches"] = predictor.planar_batches - planar0
    record["seconds"] = time.perf_counter() - t0
    record["host_s"] = timer.totals()
    return str(output_path)


def predict_raster(
    predict_model: str,
    raster_path: str,
    output_path: Optional[str] = None,
    patch_size: Optional[int] = None,
    patch_overlap: float = 0.2,
    batch_size: int = 16,
    regression: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
    class_zero: bool = False,
    spatial: int = 1,
    tta: bool = False,
    device_budget_bytes: int = 4 << 30,
    host_budget_bytes: int = 16 << 30,
    predictor: Optional[Predictor] = None,
    out_compress: Optional[str] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """Serve a whole GeoTIFF of any size: sliding windows, batched through
    the model, their overlap sums added and finalized on the device.

    The tier follows the scene, as in the JAX package:

    * the mosaic (``mosaic_bytes``) fits ``device_budget_bytes`` and the
      card's free memory: one ``DeviceMosaic`` (``_serve_full``);
    * else the scene is read into RAM and served through a band of rows on
      the device (``_serve_banded``) into an output array;
    * scene plus mosaic past ``host_budget_bytes``: the streamed path
      (``predict_raster_streamed``); it needs ``output_path``
      (``ValueError`` otherwise) and returns ``(None, transform, crs)``.

    Returns (array, transform, crs) and writes a georeferenced GeoTIFF when
    ``output_path`` is given. Under ``spatial`` the ranks pick rank 0's
    tier, and the others return (None, transform, crs)."""
    device = resolve_device(device)
    _check_out_compress(out_compress, regression, all_classes, specific_class)
    if predictor is None:
        predictor = Predictor(predict_model, batch_size=batch_size,
                              device=device, dtype=dtype, tta=tta,
                              spatial=spatial)
    regression = predictor.regression or regression
    patch = int(patch_size or predictor.manifest.get("patch_size", 400))
    _check_spatial(predictor, spatial, patch)

    timer = predictor.timer = StepTimer()
    t0, planar0 = time.perf_counter(), predictor.planar_batches
    with timer.phase("serve.plan"):
        info0 = tiff.read_info(raster_path)
        n_out = int(predictor.manifest.get("n_out", 2))
        stream_bytes = info0.height * info0.width * (n_out + 1) * 4 \
            + info0.height * info0.width * info0.bands * info0.dtype.itemsize
    if stream_bytes > host_budget_bytes:
        if output_path is None:
            raise ValueError(
                f"Scene needs {stream_bytes/1e9:.1f} GB in RAM; pass output_path "
                "to use the streamed whole-scene path")
        print(f"Scene+mosaic would need {stream_bytes/1e9:.1f} GB — streaming.")
        predict_raster_streamed(
            predict_model, raster_path, output_path, patch_size=patch_size,
            patch_overlap=patch_overlap, batch_size=batch_size,
            regression=regression, all_classes=all_classes,
            specific_class=specific_class, class_zero=class_zero, spatial=spatial,
            predictor=predictor, out_compress=out_compress)
        # not read back: the point is that the mosaic exceeds RAM; callers
        # stream it from the written file
        return None, info0.transform, info0.crs

    with timer.phase("serve.read"):
        scene = read_raster(raster_path)
    with timer.phase("serve.plan"):
        hwc = np.moveaxis(scene.data, 0, 2)  # view, native dtype
        h, w = hwc.shape[:2]
        mode = dict(regression=regression, all_classes=all_classes,
                    specific_class=specific_class)
        budget = device_budget_bytes
        if predictor.device.type == "cuda":
            budget = min(budget, free_device_bytes(predictor.device))
        record = {"raster": str(raster_path), "read_s": timer.samples["serve.read"][-1]}
        predictor.scenes.append(record)
        nbytes = mosaic_bytes(h, w, n_out)
        whole = nbytes <= budget
        if predictor.space is not None:  # one tier for every rank: rank 0's
            whole = mesh.broadcast_from_primary(whole, predictor.space.group)
        record["tier"] = "full" if whole else "banded"
    if whole:
        out, nodata = _serve_full(predictor, hwc, patch, patch_overlap, mode, record)
    else:
        print(f"Mosaic needs {nbytes/1e9:.1f} GB — accumulating in a band of rows "
              "on the device.")
        out = None
        done = 0

        def emit(rows: np.ndarray) -> None:
            nonlocal out, done
            if out is None:
                out = np.empty(rows.shape[:-2] + (h, w), rows.dtype)
            out[..., done:done + rows.shape[-2], :] = rows
            done += rows.shape[-2]

        nodata = _serve_banded(predictor, h, w, patch, patch_overlap,
                               lambda r0, r1: hwc[r0:r1], emit, mode, record)
    if predictor.primary:  # the other ranks hold no output
        with timer.phase("serve.write"):
            if class_zero:
                out = _apply_class_zero(out, nodata)
            t1 = time.perf_counter()
            if output_path is not None:
                write_raster(output_path, out, transform=scene.transform,
                             crs=scene.crs, nodata=nodata, compress=out_compress)
            record["write_s"] = time.perf_counter() - t1
    record["planar_batches"] = predictor.planar_batches - planar0
    record["seconds"] = time.perf_counter() - t0
    record["host_s"] = timer.totals()
    return out, scene.transform, scene.crs


def serve_scenes(predict_model: str, raster_paths, output_dir: str,
                 suffix: str = "_prediction.tif", device="cuda",
                 dtype: torch.dtype = torch.bfloat16, **kwargs) -> list:
    """Serve several scenes through ONE resident model; outputs are
    ``output_dir/<stem><suffix>``. Each scene goes through
    ``predict_raster`` and takes its own tier (``device_budget_bytes``,
    ``host_budget_bytes`` pass through). Returns the output paths."""
    device = resolve_device(device)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    predictor = kwargs.pop("predictor", None) or Predictor(
        predict_model, batch_size=kwargs.get("batch_size", 16), device=device,
        dtype=dtype, tta=kwargs.get("tta", False),
        spatial=kwargs.get("spatial", 1))
    outs = []
    for rp in raster_paths:
        out = out_dir / (Path(rp).stem + suffix)
        predict_raster(predict_model, str(rp), str(out), predictor=predictor,
                       device=device, dtype=dtype, **kwargs)
        outs.append(out)
        print(f"Served {rp} -> {out}")
    return outs


def save_predictions(
    predict_model: str,
    predict_path: str,
    regression: bool = False,
    merge: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
    large_file: bool = False,
    AOI: Optional[str] = None,
    year: Optional[str] = None,
    validation_vision: bool = False,
    class_zero: bool = False,
    batch_size: int = 16,
    spatial: int = 1,
    tta: bool = False,
    device_merge: bool = False,
    reference_quirks: bool = False,
    predictor: Optional[Predictor] = None,
    out_compress: Optional[str] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Path:
    """Predict every ``*.tif`` tile under ``predict_path``.

    Returns the output folder (tiles mode: ``predicted_tiles_<model>``
    beside ``predict_path``) or the mosaic's path (merge mode:
    ``<AOI>_<year>_<model>_prediction.tif`` beside ``predict_path``).
    Tiles are grouped by shape and batched within a group; a group's last
    batch is padded by repeating its final tile. ``device_merge=True``
    accumulates the mosaic on the device (the ``blend_count`` kernel on the
    card) in float32 and finalizes it there (``DeviceMosaic.finish``), so
    ``large_file`` quantization happens once at the end rather than per
    tile; a mosaic larger than the card's free memory raises
    ``RuntimeError``. ``predictor`` reuses a resident
    :class:`Predictor` or an ``artifact.ArtifactPredictor``.

    The three stages overlap: tile reads run on two threads, and on the
    card each batch's output is copied into pinned host memory behind its
    forward with an event recorded after it; the host writes batch k once
    batch k's event has passed, while batch k+1's forward runs.

    ``validation_vision`` (tiles mode, not regression): after the tiles
    are written, ``figures.plot_valid_predict`` prints the tile-majority
    confusion matrix and classification report against the masks beside
    ``predict_path`` and draws them where matplotlib, seaborn and pandas
    are installed.

    Under ``spatial`` every rank reads the same batches; rank 0 alone
    writes the tiles or merges the mosaic, and every rank returns the same
    path.
    """
    if predictor is None:
        predictor = Predictor(predict_model, batch_size=batch_size, device=device,
                              dtype=dtype, tta=tta, spatial=spatial)
    if regression != predictor.regression:
        regression = predictor.regression
    # the reference gates large_file int8 stretching on TRUTHY specific_class
    # (predict.py:245-249), so class 0 behaves like None there; the default
    # treats any explicit class (including 0) as selected
    sc_selected = bool(specific_class) if reference_quirks else (specific_class is not None)
    _check_out_compress(out_compress, regression, all_classes, specific_class, large_file)

    path = Path(predict_path)
    model_name = Path(predict_model).stem
    output_folder = path.parent if merge else path.parent / ("predicted_tiles_" + model_name)
    out_file = output_folder / ("_".join(filter(None, [AOI, year, model_name, "prediction"]))
                                + ".tif")

    tiles = sorted(path.glob("*.tif"))
    if not tiles:
        raise FileNotFoundError(f"No .tif tiles under {path}")
    print(f"Started at: {time.strftime('%H:%M:%S')} — {len(tiles)} tiles")

    # batches need one shape: group the tiles by (H, W)
    by_shape: dict = {}
    for t in tiles:
        info = tiff.read_info(str(t))
        by_shape.setdefault((info.height, info.width), []).append(t)
    if len(by_shape) > 1:
        print(f"{len(by_shape)} distinct tile sizes; predicting group-wise")
    for height, _ in by_shape:
        _check_spatial(predictor, spatial, height)
    tiles = [t for group in by_shape.values() for t in group]

    bs = predictor.batch_size
    # batch within shape groups only (a batch never straddles two groups)
    batch_ends = {}
    offset = 0
    for group in by_shape.values():
        for s in range(offset, offset + len(group), bs):
            batch_ends[s] = min(s + bs, offset + len(group))
        offset += len(group)

    def load_batch(start):
        chunk = tiles[start:batch_ends[start]]
        rasters = [read_raster(t) for t in chunk]
        batch = np.stack([np.moveaxis(r.data, 0, 2) for r in rasters])
        if len(chunk) < bs:  # pad the group's last batch
            batch = np.concatenate([batch, np.repeat(batch[-1:], bs - len(chunk), axis=0)])
        return start, chunk, rasters, batch

    if _forwards_only(predictor, (load_batch(start)[3] for start in batch_ends)):
        return out_file if merge else output_folder

    output_folder.mkdir(parents=True, exist_ok=True)
    accumulator: Optional[MosaicAccumulator] = None
    device_mosaic: Optional[DeviceMosaic] = None
    if merge:
        infos = [tile_extent_info(str(t)) for t in tiles]
        if device_merge:
            tile_rows, tile_cols, y_len, x_len, mosaic_transform = grid_layout(infos)
            device_mosaic = DeviceMosaic(y_len, x_len, int(predictor.manifest.get("n_out", 2)),
                                         device=predictor.device)
            mosaic_crs = infos[0].crs
        else:
            accumulator = MosaicAccumulator(infos, large_file=large_file)

    def process(chunk, rasters, host, event):
        """Host side of one batch: per-tile select / quantize / write."""
        if event is not None:
            event.synchronize()
        for tile_path, raster, p in zip(chunk, rasters, host.numpy()):
            if p.ndim == 2:
                # the class map argmax'd on the device (default mode)
                out = p
                if class_zero:
                    out = _apply_class_zero(out, None).astype(out.dtype)
                write_raster(output_folder / tile_path.name, out,
                             transform=raster.transform, crs=raster.crs,
                             compress=out_compress)
                continue
            class_stack = p  # (C, H, W)
            if merge:
                if large_file and class_stack.max() <= 1:
                    class_stack = np.around(class_stack * ((128 / 4) - 1)).astype(np.int8)
                accumulator.add(class_stack, str(tile_path))
                continue
            if regression or all_classes:
                out = class_stack
            elif specific_class is None:
                out = class_stack.argmax(axis=0).astype(np.uint8)
            else:
                out = class_stack[specific_class]
            # int8 input (stretched on the device) has max 31 and is kept
            if large_file and np.max(class_stack) <= 1 and (all_classes or sc_selected):
                out = np.around(out * ((128 / 4) - 1)).astype(np.int8)
            if class_zero:
                out = _apply_class_zero(out, None).astype(out.dtype)
            write_raster(output_folder / tile_path.name, out,
                         transform=raster.transform, crs=raster.crs,
                         compress=out_compress)

    # large_file's int8 stretch on the device (×31, round half to even as
    # np.around; softmax probabilities are <= 1, so the reference's
    # max() <= 1 gate always holds) and the default mode's argmax on the
    # device: 4× and 4·C× fewer bytes to the host
    use_int8 = large_file and not regression and not merge and (all_classes or sc_selected)
    use_argmax = (not merge and not regression and not all_classes
                  and specific_class is None)

    read_pool = cf.ThreadPoolExecutor(max_workers=2, thread_name_prefix="tiles")
    starts_iter = iter(batch_ends)
    reads: deque = deque()
    for _ in range(2):
        start = next(starts_iter, None)
        if start is not None:
            reads.append(read_pool.submit(load_batch, start))
    pending: deque = deque()  # (chunk, rasters, host tensor, event)
    try:
        with TileProgress(len(tiles)) as prog:
            while reads:
                fut = reads.popleft()
                start = next(starts_iter, None)
                if start is not None:
                    reads.append(read_pool.submit(load_batch, start))
                start, chunk, rasters, batch = fut.result()
                if device_mosaic is not None:
                    probs = predictor.predict_batch_device(batch)[:len(chunk)]
                    device_mosaic.add_batch(probs, tile_rows[start:start + len(chunk)],
                                            tile_cols[start:start + len(chunk)])
                    prog.update(len(chunk))
                    continue
                out = predictor.predict_batch_device(
                    batch, quantize_int8=use_int8, argmax_u8=use_argmax)[:len(chunk)]
                pending.append((chunk, rasters, *_fetch(out)))
                if len(pending) > 1:
                    item = pending.popleft()
                    process(*item)
                    prog.update(len(item[0]))
            while pending:
                item = pending.popleft()
                process(*item)
                prog.update(len(item[0]))
    finally:
        read_pool.shutdown(wait=False)

    if validation_vision and not merge and not regression:
        plot_valid_predict(str(output_folder), str(path), class_zero=class_zero)
    if not merge:
        return output_folder
    if device_mosaic is not None:
        # finalized on the device; only the finished mosaic crosses
        out, nodata = device_mosaic.finish(regression=regression, all_classes=all_classes,
                                           specific_class=specific_class)
        host, event = _fetch(out)
        if event is not None:
            event.synchronize()
        mosaic = host.numpy()
        if large_file and not regression and (all_classes or sc_selected) \
                and np.max(mosaic) <= 1:
            mosaic = np.around(mosaic * ((128 / 4) - 1)).astype(np.int8)
        transform, crs = mosaic_transform, mosaic_crs
    else:
        mosaic, transform, nodata = accumulator.finalize(
            regression=regression, all_classes=all_classes, specific_class=specific_class)
        crs = accumulator.crs
    if class_zero:
        mosaic = _apply_class_zero(mosaic, nodata)
    write_raster(out_file, mosaic, transform=transform, crs=crs, nodata=nodata,
                 compress=out_compress)
    print(f"Prediction stored in {output_folder}.")
    return out_file
