"""Whole-scene prediction: window → batch → forward → blend, no tile files.

Counterpart of ``unet_tpu/predict/predict.py``'s serve path. Scenes stay
in their storage dtype on the host; each batch of windows crosses to the
device in that dtype, is scaled there, runs through the U-Net in the
compute dtype (bf16 on the card), and its probabilities are blended into a
device-resident mosaic by the ``blend_count`` CUDA kernel. Only the
finished mosaic comes back to the host.

Output modes: argmax class map (uint8, default), ``all_classes``
(float32 stack), ``specific_class`` (float32 band), ``regression``
(float32 values, nodata −9999), ``class_zero`` (0 → nodata, classes
decremented on write).
"""

from __future__ import annotations

import time
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
from .merge import finalize_mosaic


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
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        cuda = self.device.type == "cuda"
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
                        specific_class=None) -> None:
    """JPEG output codecs only fit uint8 class maps; fail before compute."""
    if out_compress not in ("jpeg", "jpeg-lossless"):
        return
    wrong = [name for flag, name in (
        (regression, "regression (float32 output)"),
        (all_classes, "all_classes (float32 output)"),
        (specific_class is not None, "specific_class (float32 output)")) if flag]
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
