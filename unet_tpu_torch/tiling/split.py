"""GeoTIFF → training-tile pipeline.

A copy of ``unet_tpu/tiling/split.py`` (host-only numpy over the port's own
``geo`` and ``tiling/windows.py``), itself a rebuild of the reference's
offline preprocessing (create_tiles_unet.py:252-434 ``split_raster``;
:69-176 ``create_train_test_split``): sliding-window crops with
geo-alignment, joint image/mask nodata zeroing, emptiness filtering,
``class_zero`` shifting, and the on-disk dataset contract the whole stack
depends on:

    base_dir/{trai,vali[,test]}/{img_tiles,mask_tiles}/<image>_<idx>.tif

Tiling is host code in both packages: raster codecs run on the CPU, and
the device path starts at the data loader. The same scene, mask and seed
give the same tile tree, byte for byte, as the JAX package.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..geo import Raster, read_raster, write_raster
from .windows import generate_windows

SPLIT_DIRS = ("trai", "vali", "test")


def _wrap_half_pixel(offset: float, res: float) -> float:
    if offset > 0.5 * abs(res):
        offset -= abs(res)
    elif offset <= -0.5 * abs(res):
        offset += abs(res)
    return offset


def align_image_and_mask(image: Raster, mask: Raster) -> Tuple[Raster, Raster]:
    """Crop image and mask to their common extent on the image grid.

    Equivalent to the reference's adjustment block
    (create_tiles_unet.py:306-358): resolutions rounded to mm precision,
    sub-pixel origin offsets wrapped to ±half a pixel, extents intersected,
    both rasters cropped to the intersection.
    """
    it, mt = image.transform, mask.transform
    if it is None or mt is None:
        if image.data.shape[1:] != mask.data.shape[1:]:
            raise ValueError("Image and mask shapes differ and no georeferencing available")
        return image, mask

    img_w, img_h = round(it[1], 3), round(it[5], 3)
    msk_w, msk_h = round(mt[1], 3), round(mt[5], 3)
    same_origin = (round(it[0], 3) == round(mt[0], 3)) and (round(it[3], 3) == round(mt[3], 3))
    if same_origin and image.data.shape[1:] == mask.data.shape[1:]:
        return image, mask

    print("Image and mask sizes do not match. Performing adjustments... ")
    # sub-pixel offset of the mask grid relative to the image grid
    w_off = _wrap_half_pixel(round((it[0] / img_w % 1 - mt[0] / msk_w % 1) * msk_w, 3), msk_w)
    h_off = _wrap_half_pixel(round((it[3] / img_h % 1 - mt[3] / msk_h % 1) * msk_h, 3), msk_h)
    msk_l, msk_t = mt[0] + w_off, mt[3] + h_off

    img_x = (it[0], it[0] + img_w * image.width)
    img_y = (it[3] + img_h * image.height, it[3])  # (bottom, top); img_h < 0
    msk_x = (msk_l, msk_l + msk_w * mask.width)
    msk_y = (msk_t + msk_h * mask.height, msk_t)

    out_x = (max(img_x[0], msk_x[0]), min(img_x[1], msk_x[1]))
    out_y = (max(img_y[0], msk_y[0]), min(img_y[1], msk_y[1]))
    if out_x[0] >= out_x[1] or out_y[0] >= out_y[1]:
        raise ValueError("Image and mask extents do not overlap")

    def pixel_window(l: float, t: float, xres: float, yres: float) -> Tuple[int, int, int, int]:
        c0 = int(round((out_x[0] - l) / xres))
        c1 = int(round((out_x[1] - l) / xres))
        r0 = int(round((out_y[1] - t) / yres))
        r1 = int(round((out_y[0] - t) / yres))
        return r0, r1, c0, c1

    ir0, ir1, ic0, ic1 = pixel_window(it[0], it[3], img_w, img_h)
    mr0, mr1, mc0, mc1 = pixel_window(msk_l, msk_t, msk_w, msk_h)
    # guard against rounding drift: force identical crop shapes
    rows = min(ir1 - ir0, mr1 - mr0)
    cols = min(ic1 - ic0, mc1 - mc0)
    image = image.window(ir0, ir0 + rows, ic0, ic0 + cols)
    mask = mask.window(mr0, mr0 + rows, mc0, mc0 + cols)
    assert image.data.shape[1:] == mask.data.shape[1:], "Some issue with the adjustments"
    print(f"Done! Adjusted images new size is {image.data.shape[1:]}.\n")
    return image, mask


def _joint_nodata_zero(image: Raster, mask: Optional[Raster]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Zero out pixels where ANY image band or the mask equals its nodata.

    Matches create_tiles_unet.py:360-388 (joint zeroing keeps image and mask
    consistent so the ``max_empty`` filter sees the same holes in both).
    """
    img = np.array(image.data, copy=True)
    bad = np.zeros(img.shape[1:], dtype=bool)
    if image.nodata is not None:
        bad |= (img == image.nodata).any(axis=0)
    if mask is not None:
        msk = np.array(mask.data, copy=True)
        if mask.nodata is not None:
            bad |= (msk == mask.nodata).any(axis=0)
        msk[:, bad] = 0
    else:
        msk = None
    img[:, bad] = 0
    return img, msk


def _tile_dtype(raster_dtype: np.dtype) -> np.dtype:
    """Image-tile storage dtype (create_tiles_unet.py:209-219)."""
    name = np.dtype(raster_dtype).name
    if name.endswith("int16"):
        return np.dtype(np.uint16)
    if name.endswith("int8"):
        return np.dtype(np.uint8)
    if name.endswith("float32"):
        return np.dtype(np.float32)
    raise ValueError(f"raster_dtype error: {name}")


def split_raster(
    path_to_raster: str,
    path_to_mask: Optional[str] = None,
    base_dir: str = ".",
    patch_size: int = 400,
    patch_overlap: float = 0.2,
    split: Optional[Sequence[float]] = None,
    max_empty: float = 0.9,
    class_zero: bool = False,
    seed: Optional[int] = None,
    reference_quirks: bool = False,
    compress: Optional[str] = None,
) -> int:
    """Cut a large GeoTIFF (+ optional mask) into training/prediction tiles.

    Full behavioral equivalent of create_tiles_unet.py:252-434. Returns the
    number of tiles written (the reference returns nothing; the count is
    useful for tests and logs). ``compress`` applies geo.tiff write
    compression to the image tiles (the reference writes uncompressed,
    create_tiles_unet.py:208-249); mask tiles keep exact labels, so lossy
    ``"jpeg"`` maps to ``"deflate"`` for them.
    """
    if split is None:
        split = [0.7, 0.2, 0.1]
    include_mask = path_to_mask is not None

    image = read_raster(path_to_raster)
    bands_img = image.bands
    raster_dtype = image.dtype

    mask = None
    mask_dtype = None
    if include_mask:
        mask = read_raster(path_to_mask)
        mask_dtype = mask.dtype
        if class_zero:
            m = np.array(mask.data, copy=True)
            if mask.nodata is not None:
                m[m != mask.nodata] += 1
            else:
                m += 1
            mask = Raster(m, mask.transform, mask.crs, mask.nodata)
        image, mask = align_image_and_mask(image, mask)

    img_arr, msk_arr = _joint_nodata_zero(image, mask)

    height, width = img_arr.shape[1:]
    if height < patch_size or width < patch_size:
        raise ValueError(
            f"Patch size of {patch_size} is larger than the image dimensions {[height, width]}"
        )

    windows = generate_windows(height, width, patch_size, patch_overlap)
    image_basename = os.path.splitext(os.path.basename(path_to_raster))[0]

    base = Path(base_dir)
    img_dir = base / "img_tiles"
    img_dir.mkdir(parents=True, exist_ok=True)
    if include_mask:
        msk_dir = base / "mask_tiles"
        msk_dir.mkdir(parents=True, exist_ok=True)

    tile_img_dtype = _tile_dtype(raster_dtype)
    tile_msk_dtype = (
        np.dtype(np.float32) if (mask_dtype is not None and "float" in mask_dtype.name) else np.dtype(np.uint8)
    )

    n_saved = 0
    min_filled = 1.0 - max_empty
    for index, win in enumerate(windows):
        rs, cs = win.indices()
        crop = img_arr[:, rs, cs]
        if crop.size == 0:
            continue
        if np.count_nonzero(crop) < crop.size * min_filled:
            continue
        if include_mask:
            crop_mask = msk_arr[:, rs, cs]
            if crop_mask.size == 0:
                continue
            if np.count_nonzero(crop_mask) < crop_mask.size * min_filled:
                continue

        tile_transform = None
        if image.transform is not None:
            ulx, xres, xrot, uly, yrot, yres = image.transform
            if reference_quirks:
                # create_tiles_unet.py:224-226 computes the tile's y origin
                # with the X resolution: uly - ymax*geotrans[1]. Identical
                # for square pixels (yres == -xres), wrong otherwise.
                tile_uly = uly - win.y * xres
            else:
                tile_uly = uly + win.y * yres
            tile_transform = (ulx + win.x * xres, xres, 0.0, tile_uly, 0.0, yres)

        write_raster(
            img_dir / f"{image_basename}_{index}.tif",
            crop.astype(tile_img_dtype),
            transform=tile_transform,
            crs=image.crs,
            compress=compress,
        )
        if include_mask:
            write_raster(
                msk_dir / f"{image_basename}_{index}.tif",
                crop_mask.astype(tile_msk_dtype),
                transform=tile_transform,
                crs=image.crs,
                compress="deflate" if compress == "jpeg" else compress,
            )
        n_saved += 1

    if include_mask:
        create_train_test_split(base_dir, split=split, seed=seed)
    return n_saved


def create_train_test_split(path: str, split: Optional[Sequence[float]] = None, seed: Optional[int] = None) -> None:
    """Shuffle tiles and move image/mask pairs into ``trai/vali[/test]``.

    Behavioral match of create_tiles_unet.py:69-176: ratio list of 2 or 3
    entries, reset to ``[0.7, 0.2, 0.1]`` with a warning when it does not sum
    to 1, empty source dirs removed afterwards. The permutation is
    ``np.random.default_rng(seed).permutation`` over the sorted tile names,
    as in the JAX package, so a seed splits tile for tile alike; with
    ``seed=None`` it draws from numpy's global ``np.random`` state, as the
    JAX package does.
    """
    if split is None:
        split = [0.7, 0.2, 0.1]
    split = list(split)
    if np.round(np.sum(split), decimals=3) != 1.0:
        split = [0.7, 0.2, 0.1]
        warnings.warn("Train/Vali/Test-Split percentage does not sum to 1, reseting to 70%/20%/10%.")

    base = Path(path)
    img_src = base / "img_tiles"
    msk_src = base / "mask_tiles"
    has_test = len(split) == 3 and split[-1] != 0

    dests = ["trai", "vali"] + (["test"] if has_test else [])
    for d in dests:
        (base / d / "img_tiles").mkdir(parents=True, exist_ok=True)
        (base / d / "mask_tiles").mkdir(parents=True, exist_ok=True)

    files = sorted(img_src.glob("*.tif"))
    rng = np.random.default_rng(seed) if seed is not None else np.random
    perm = rng.permutation(len(files))
    files = [files[i] for i in perm]

    n = len(files)
    n_train = int(n * split[0])
    if has_test:
        n_vali_end = int(n * float(np.sum(split[:2])))
        groups = {"trai": files[:n_train], "vali": files[n_train:n_vali_end], "test": files[n_vali_end:]}
    else:
        groups = {"trai": files[:n_train], "vali": files[n_train:]}

    for dest_name, group in groups.items():
        for img_file in group:
            name = img_file.name
            os.rename(img_file, base / dest_name / "img_tiles" / name)
            mask_file = msk_src / name
            if mask_file.exists():
                os.rename(mask_file, base / dest_name / "mask_tiles" / name)

    for d in (img_src, msk_src):
        if d.exists() and not any(d.iterdir()):
            d.rmdir()
