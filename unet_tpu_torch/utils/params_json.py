"""Params-JSON loaders + misc numeric helpers.

The port's copy of ``unet_tpu/utils/params_json.py``: the reference's JSON
param loaders (create_tiles_unet.py:438-456 ``load_json_params``;
train.py:41-59 ``load_split_raster_params``) and the MAD outlier detector
(utils.py:92-103 ``is_outlier``, present-but-unused in the reference; kept
for surface parity).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def load_json_params(json_path: str) -> Dict:
    """Load parameters from a JSON file (create_tiles_unet.py:438-456)."""
    if not os.path.exists(json_path):
        raise FileNotFoundError(f"JSON file not found: {json_path}")
    with open(json_path, "r") as json_file:
        return json.load(json_file)


# train.py:41-59 is an identical copy in the reference
load_split_raster_params = load_json_params


def is_outlier(points: np.ndarray, thresh: float = 3.5) -> np.ndarray:
    """Boolean mask of outliers via modified z-score (utils.py:92-103)."""
    points = np.asarray(points)
    if len(points.shape) == 1:
        points = points[:, None]
    median = np.median(points, axis=0)
    diff = np.sqrt(np.sum((points - median) ** 2, axis=-1))
    med_abs_deviation = np.median(diff)
    modified_z_score = 0.6745 * diff / med_abs_deviation
    return modified_z_score > thresh
