"""Tile dataset discovery and pairing.

Counterpart of ``unet_tpu/data/dataset.py`` over the port's own ``geo``:
walk every ``<scene>/img_tiles`` folder under the data path, pair each
image tile with the same-named file in ``mask_tiles``, and split train/valid
by the scene folder's name. All scene folders are scanned, so tiles in a
``test`` folder land in the training split unless listed in
``valid_scenes`` (the reference's behaviour).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..geo import read_raster
from ..geo import tiff as tiff_codec


def get_image_tiles(path: Path) -> List[Path]:
    """All image tiles under ``<path>/*/img_tiles``."""
    path = Path(path)
    files: List[Path] = []
    for folder in sorted(p for p in path.iterdir() if p.is_dir()):
        img_dir = folder / "img_tiles"
        if img_dir.is_dir():
            files.extend(sorted(img_dir.glob("*.tif")))
    return files


def get_mask_path(img_path: Path) -> Path:
    """img_tiles → mask_tiles, same filename."""
    return Path(str(img_path).replace("img_tiles", "mask_tiles"))


def get_datatype(path: Path) -> str:
    """'int8' | 'int16' from the first training tile's max value over the
    pixels whose band 0 is not nodata: < 257 → int8, else int16 (the
    reference's threshold)."""
    first = sorted((Path(path) / "trai" / "img_tiles").glob("*.tif"))
    if not first:
        raise FileNotFoundError(f"No training tiles under {path}/trai/img_tiles")
    r = read_raster(first[0])
    img = r.data
    if r.nodata is not None:
        valid = img[:, img[0] != r.nodata]
        max_val = valid.max() if valid.size else img.max()
    else:
        max_val = img.max()
    if max_val < 257:
        print("Data in int8")
        return "int8"
    print("Data in int16")
    return "int16"


def get_patch_size(base_dir: Path) -> Tuple[int, Optional[Tuple[float, float]], str, int]:
    """(width, resolution, dtype, bands) of the first training tile, for the
    run manifest."""
    img_dir = Path(base_dir) / "trai" / "img_tiles"
    files = sorted(img_dir.glob("*.tif"))
    if not files:
        raise ValueError("No .tif files found in the directory")
    info = tiff_codec.read_info(str(files[0]))
    resolution = None
    if info.transform is not None:
        resolution = (abs(info.transform[1]), abs(info.transform[5]))
    return info.width, resolution, str(info.dtype), info.bands


@dataclass
class TileDataset:
    """Paired image/mask tiles with a folder-name-based train/valid split."""

    data_path: Path
    valid_scenes: Sequence[str] = ("vali",)
    train_files: List[Path] = field(default_factory=list)
    valid_files: List[Path] = field(default_factory=list)

    def __post_init__(self):
        self.data_path = Path(self.data_path)
        files = get_image_tiles(self.data_path)
        if not files:
            raise FileNotFoundError(f"No image tiles under {self.data_path}/*/img_tiles")
        for f in files:
            scene = f.parent.parent.name
            (self.valid_files if scene in self.valid_scenes else self.train_files).append(f)

    def load_pair(self, img_path: Path) -> Tuple[np.ndarray, np.ndarray]:
        """(image (C,H,W) in the tile's own dtype, mask (H,W)) for one tile.

        Images and integer masks stay in their storage dtype, so a uint8
        tile costs 1 byte a pixel through host RAM and the copy to the
        device; float-stored class masks become int32. Mask band 0 only."""
        img = read_raster(img_path).data
        msk = read_raster(get_mask_path(img_path)).data[0]
        if msk.dtype.kind not in "iu":
            msk = msk.astype(np.int32)
        return img, msk

    @property
    def n_train(self) -> int:
        return len(self.train_files)

    @property
    def n_valid(self) -> int:
        return len(self.valid_files)
