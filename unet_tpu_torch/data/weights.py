"""Class weights for the cross-entropy loss.

Counterpart of ``unet_tpu/data/weights.py`` (without the reference-quirks
sampler):

* ``"even"`` → ``ones(n) / n``;
* ``"weighted"`` → inverse frequency, weight_c = total_px / count_c, counted
  over (up to) the first 1200 training mask tiles; absent classes get 0;
* an explicit list → used as given.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..geo import read_raster

MAX_WEIGHT_TILES = 1200


def compute_class_weights(data_path: Path, n_classes: int,
                          max_tiles: int = MAX_WEIGHT_TILES) -> List[float]:
    mask_dir = Path(data_path) / "trai" / "mask_tiles"
    files = sorted(mask_dir.glob("*.tif"))[:max_tiles]
    if not files:
        raise FileNotFoundError(f"No mask tiles under {mask_dir}")
    counts = np.zeros(n_classes, dtype=np.int64)
    for f in files:
        m = read_raster(f).data.astype(np.int64).ravel()
        counts += np.bincount(m, minlength=n_classes)[:n_classes]
    total = counts.sum()
    return [float(total / c) if c > 0 else 0.0 for c in counts]


def resolve_class_weights(spec: Union[str, Sequence[float], None],
                          codes: Sequence[str],
                          data_path: Optional[Path] = None) -> List[float]:
    """"even" | "weighted" | a list of one weight per code."""
    if spec is None or spec == "even":
        return (np.ones(len(codes)) / len(codes)).tolist()
    if isinstance(spec, str):
        if spec == "weighted":
            if data_path is None:
                raise ValueError("'weighted' class weights need a data_path")
            return compute_class_weights(data_path, len(codes))
        raise ValueError(f"Unknown class-weight spec {spec!r} (use 'even', 'weighted', or a list)")
    weights = [float(w) for w in spec]
    if len(weights) != len(codes):
        raise ValueError(f"{len(weights)} class weights for {len(codes)} codes")
    return weights
