"""Overlap-averaged mosaic finalization (a copy of ``finalize_mosaic`` from
``unet_tpu/predict/merge.py``; the tile-file ``MosaicAccumulator`` comes
with ``save_predictions`` in a later slice)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def finalize_mosaic(
    merged: np.ndarray,
    counter: np.ndarray,
    regression: bool = False,
    all_classes: bool = False,
    specific_class: Optional[int] = None,
    large_file: bool = False,
) -> Tuple[np.ndarray, Optional[float]]:
    """Shared divide/argmax/select logic (reference predict.py:307-345)."""
    nodata: Optional[float] = None
    int8_mode = large_file and merged.dtype == np.int8
    merged = np.array(merged, dtype=np.int8 if int8_mode else np.float32)
    counter = np.asarray(counter)
    if regression:
        merged = merged[0] if merged.ndim == 3 else merged
        counter = counter[0] if counter.ndim == 3 else counter
        pos = counter > 0
        merged[pos] /= counter[pos]
        nodata = -9999
        merged[~pos] = nodata
        return merged, nodata
    if counter.ndim < merged.ndim:
        counter = np.broadcast_to(counter[None], merged.shape)
    pos = counter > 0
    if int8_mode:
        merged[pos] //= counter[pos].astype(np.int8)
    else:
        merged[pos] /= counter[pos]
    if all_classes:
        pass
    elif specific_class is None:
        merged = merged.argmax(axis=0).astype(np.uint8)
    else:
        merged = merged[specific_class]
    return merged, nodata
