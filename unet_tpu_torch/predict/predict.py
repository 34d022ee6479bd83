"""Batched prediction with georeferenced outputs: whole scenes and tile sets.

Counterpart of ``unet_tpu/predict/predict.py``. Rasters stay in their
storage dtype on the host; each batch crosses to the device in that dtype
(through pinned memory on the card, without waiting for earlier work), is
scaled there, and runs through the U-Net in the compute dtype (bf16 on the
card).

* ``predict_raster`` (``serve``): sliding windows over one scene, blended
  into a device-resident mosaic by the ``blend_count`` CUDA kernel; only
  the finished mosaic comes back to the host.
* ``save_predictions`` (``predict``): every tile file of a folder, written
  back as predicted tiles or merged into an overlap-averaged mosaic, on the
  host (``MosaicAccumulator``) or on the card (``device_merge``, the
  ``blend_count`` kernel).

Output modes: argmax class map (uint8, default), ``all_classes``
(float32 stack), ``specific_class`` (float32 band), ``regression``
(float32 values, nodata −9999 in a mosaic), ``large_file`` (tiles:
probabilities stretched to int8 ×31; a host mosaic: int8 sums),
``class_zero`` (0 → nodata, classes decremented on write).
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from collections import deque
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..data.augment import image_scale
from ..geo import read_raster, tiff, write_raster
from ..models.layers import pixel_shuffle
from ..ops.blend import DeviceMosaic
from ..tiling.windows import generate_windows
from ..train.checkpoint import load_bundle
from ..utils.device import resolve_device
from ..utils.progress import TileProgress
from .merge import MosaicAccumulator, finalize_mosaic, grid_layout, tile_extent_info


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


def tta_probs_fn(probs_fn):
    """4-fold flip test-time augmentation: the mean of the probabilities
    over {identity, hflip, vflip, hvflip}."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        acc = probs_fn(x)
        for dims in ((3,), (2,), (2, 3)):
            acc = acc + torch.flip(probs_fn(torch.flip(x, dims)), dims)
        return acc / 4

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


class Predictor:
    """Loads a bundle onto ``device`` and predicts batches of equally sized
    tiles. ``dtype`` is the compute dtype (bf16 on the card)."""

    def __init__(self, bundle: str, batch_size: int = 16, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, tta: bool = False,
                 spatial: int = 1):
        self.device = resolve_device(device)
        if int(spatial) > 1:
            raise NotImplementedError("spatial partitioning: not yet ported")
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
        self.probs_fn = tta_probs_fn(probs_fn) if self.tta else probs_fn
        self._timings: List = []  # per forward: CUDA event pair or seconds

    @torch.inference_mode()
    def predict_batch_device(self, images: np.ndarray,
                             quantize_int8: bool = False,
                             argmax_u8: bool = False) -> torch.Tensor:
        """(B,H,W,C) raw tile values → device (B,n_out,H,W) probabilities
        (or the finished forms of ``finish_probs``). Tiles cross to the
        device in their storage dtype; the float cast and scaling run
        there."""
        x = torch.from_numpy(np.ascontiguousarray(images))
        cuda = self.device.type == "cuda"
        # from pinned memory the copy is queued behind earlier work instead
        # of waiting for it, as a pageable copy does
        x = x.pin_memory().to(self.device, non_blocking=True) if cuda else x
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        x = x.permute(0, 3, 1, 2).to(torch.float32) * self.scale
        out = finish_probs(self.probs_fn(x), quantize_int8=quantize_int8,
                           argmax_u8=argmax_u8)
        if cuda:
            end.record()
            self._timings.append((start, end))
        else:
            self._timings.append(time.perf_counter() - t0)
        return out

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """(B,H,W,C) → host (B,H,W,n_out) probabilities (the JAX
        package's layout)."""
        return self.predict_batch_device(images).permute(0, 2, 3, 1).cpu().numpy()

    def forward_ms(self) -> List[float]:
        """Milliseconds of every forward so far (device time on CUDA)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [s.elapsed_time(e) for s, e in self._timings]
        return [t * 1e3 for t in self._timings]


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
    host_budget_bytes: int = 16 << 30,
    predictor: Optional[Predictor] = None,
    out_compress: Optional[str] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
):
    """Serve a whole GeoTIFF: sliding windows in batches of ``batch_size``
    (the last one padded by repeating its final window), blended into a
    device mosaic. A mosaic larger than the card's free memory raises
    ``NotImplementedError`` (the banded on-card path is not ported yet).
    Returns (array, transform, crs) and writes a georeferenced GeoTIFF when
    ``output_path`` is given."""
    device = resolve_device(device)
    _check_out_compress(out_compress, regression, all_classes, specific_class)
    if predictor is None:
        predictor = Predictor(predict_model, batch_size=batch_size,
                              device=device, dtype=dtype, tta=tta,
                              spatial=spatial)
    regression = predictor.regression or regression

    info0 = tiff.read_info(raster_path)
    n_out = int(predictor.manifest.get("n_out", 2))
    stream_bytes = info0.height * info0.width * (n_out + 1) * 4 \
        + info0.height * info0.width * info0.bands * info0.dtype.itemsize
    if stream_bytes > host_budget_bytes:
        # the O(band)-memory streamed path comes with a later slice
        raise NotImplementedError(
            f"scene needs {stream_bytes / 1e9:.1f} GB in RAM; "
            "predict_raster_streamed is not yet ported")

    scene = read_raster(raster_path)
    hwc = np.moveaxis(scene.data, 0, 2)  # view, native dtype
    h, w = hwc.shape[:2]
    patch = int(patch_size or predictor.manifest.get("patch_size", 400))
    windows = generate_windows(h, w, patch, patch_overlap)

    mosaic = DeviceMosaic(h, w, n_out, device=predictor.device)
    bs = predictor.batch_size
    for start in range(0, len(windows), bs):
        chunk = windows[start:start + bs]
        batch = np.stack([hwc[win.indices()] for win in chunk])
        if len(chunk) < bs:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], bs - len(chunk), axis=0)], axis=0)
        probs = predictor.predict_batch_device(batch)[:len(chunk)]
        mosaic.add_batch(probs, [win.y for win in chunk], [win.x for win in chunk])

    summed, counter = mosaic.finalize()
    out, nodata = finalize_mosaic(summed, counter, regression=regression,
                                  all_classes=all_classes,
                                  specific_class=specific_class)
    if class_zero:
        out = _apply_class_zero(out, nodata)
    if output_path is not None:
        write_raster(output_path, np.asarray(out), transform=scene.transform,
                     crs=scene.crs, nodata=nodata, compress=out_compress)
    return np.asarray(out), scene.transform, scene.crs


def serve_scenes(predict_model: str, raster_paths, output_dir: str,
                 suffix: str = "_prediction.tif", device="cuda",
                 dtype: torch.dtype = torch.bfloat16, **kwargs) -> list:
    """Serve several scenes through ONE resident model; outputs are
    ``output_dir/<stem><suffix>``. Returns the output paths."""
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
    card) in float32, so ``large_file`` quantization happens once at the
    end rather than per tile. ``predictor`` reuses a resident
    :class:`Predictor`.

    The three stages overlap: tile reads run on two threads, and on the
    card each batch's output is copied into pinned host memory behind its
    forward with an event recorded after it; the host writes batch k once
    batch k's event has passed, while batch k+1's forward runs.

    Not ported yet (``NotImplementedError``): ``validation_vision`` (the
    figures need matplotlib and pandas), ``spatial > 1`` and serving
    artifacts as ``predictor``.
    """
    if validation_vision:
        raise NotImplementedError(
            "validation_vision (figures with matplotlib and pandas) is not yet ported")
    if int(spatial) > 1:
        raise NotImplementedError("spatial partitioning: not yet ported")
    if predictor is None:
        predictor = Predictor(predict_model, batch_size=batch_size, device=device,
                              dtype=dtype, tta=tta)
    elif not isinstance(predictor, Predictor):
        raise NotImplementedError(
            f"{type(predictor).__name__}: serving artifacts are not yet ported")
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
    output_folder.mkdir(parents=True, exist_ok=True)

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
    tiles = [t for group in by_shape.values() for t in group]

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

    if not merge:
        return output_folder
    if device_mosaic is not None:
        summed, counter = device_mosaic.finalize()
        mosaic, nodata = finalize_mosaic(summed, counter, regression=regression,
                                         all_classes=all_classes,
                                         specific_class=specific_class)
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
    name = "_".join(filter(None, [AOI, year, model_name, "prediction"])) + ".tif"
    out_file = output_folder / name
    write_raster(out_file, mosaic, transform=transform, crs=crs, nodata=nodata,
                 compress=out_compress)
    print(f"Prediction stored in {output_folder}.")
    return out_file
