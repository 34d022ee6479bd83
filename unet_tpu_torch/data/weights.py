"""Class weights for the cross-entropy loss.

Counterpart of ``unet_tpu/data/weights.py``:

* ``"even"`` → ``ones(n) / n``;
* ``"weighted"`` → inverse frequency, weight_c = total_px / count_c, counted
  over (up to) the first 1200 training mask tiles; absent classes get 0;
  under ``reference_quirks``, the reference's sampler instead (the first
  1200 of a seeded ``np.random.RandomState`` permutation of the tiles,
  ``np.unique`` counts: a class absent from the sample drops out of the
  vector);
* an explicit list → used as given;
* regression → ``[1]``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..geo import read_raster

MAX_WEIGHT_TILES = 1200


def compute_class_weights(data_path: Path, n_classes: int,
                          max_tiles: int = MAX_WEIGHT_TILES,
                          reference_quirks: bool = False, seed: int = 0) -> List[float]:
    mask_dir = Path(data_path) / "trai" / "mask_tiles"
    files = sorted(mask_dir.glob("*.tif"))
    if not files:
        raise FileNotFoundError(f"No mask tiles under {mask_dir}")
    if reference_quirks:
        # fastai's one shuffled batch of min(#tiles, 1200) tiles: the first
        # indices of the legacy MT19937 permutation
        sample = np.random.RandomState(seed).permutation(len(files))[:max_tiles]
        values = np.concatenate(
            [read_raster(files[i]).data.astype(np.int64).ravel() for i in sample])
        _, counts = np.unique(values, return_counts=True)
        total = counts.sum()
        return [float(total / c) for c in counts]
    counts = np.zeros(n_classes, dtype=np.int64)
    for f in files[:max_tiles]:
        m = read_raster(f).data.astype(np.int64).ravel()
        counts += np.bincount(m, minlength=n_classes)[:n_classes]
    total = counts.sum()
    return [float(total / c) if c > 0 else 0.0 for c in counts]


def resolve_class_weights(spec: Union[str, Sequence[float], None],
                          codes: Sequence[str],
                          data_path: Optional[Path] = None,
                          regression: bool = False,
                          reference_quirks: bool = False) -> List[float]:
    """"even" | "weighted" | a list of one weight per code; ``[1]`` for
    regression."""
    if regression:
        return [1.0]
    if spec is None or spec == "even":
        return (np.ones(len(codes)) / len(codes)).tolist()
    if isinstance(spec, str):
        if spec == "weighted":
            if data_path is None:
                raise ValueError("'weighted' class weights need a data_path")
            return compute_class_weights(data_path, len(codes),
                                         reference_quirks=reference_quirks)
        raise ValueError(f"Unknown class-weight spec {spec!r} (use 'even', 'weighted', or a list)")
    weights = [float(w) for w in spec]
    if len(weights) != len(codes):
        raise ValueError(f"{len(weights)} class weights for {len(codes)} codes")
    return weights
