"""Inputs made from a seed on the device: labelled tiles and scenes, and
the files the program reads them from.

A scene is a field of class regions (square cells of ``CELL`` pixels, a
class drawn for each) painted in one colour a class with Gaussian noise
over it, as uint8 bands; its mask is the class field. The same seed gives
the same arrays on any device of one kind."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from . import tiff

CELL = 16       # side of a class region, pixels
NOISE = 24.0    # standard deviation of the noise, grey levels
GSD = 0.2       # metres a pixel (aerial orthophoto)
EPSG = 25832    # ETRS89 / UTM 32N


def labelled(seed: int, n: int, height: int, width: int, bands: int, classes: int,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, bands, height, width) uint8, masks (n, height, width)
    uint8) on ``device``; the sides are multiples of ``CELL``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    field = torch.randint(0, classes, (n, height // CELL, width // CELL), generator=g,
                          device=device, dtype=torch.uint8)
    masks = field.repeat_interleave(CELL, 1).repeat_interleave(CELL, 2)
    colours = torch.randint(40, 216, (classes, bands), generator=g, device=device).float()
    images = torch.empty((n, bands, height, width), dtype=torch.uint8, device=device)
    for i in range(n):  # a sample at a time keeps the float32 noise small
        noise = torch.randn((bands, height, width), generator=g, device=device) * NOISE
        lit = colours[masks[i].long()].permute(2, 0, 1) + noise
        images[i] = lit.round_().clamp_(0, 255).to(torch.uint8)
    return images, masks


def write_tiles(root: Path, scene: str, images: np.ndarray, masks: np.ndarray) -> None:
    """``root/<scene>/{img,mask}_tiles/NNNN.tif``, the tile tree the
    program's ``tile`` command writes, side by side on a grid."""
    n, _, h, w = images.shape
    for kind in ("img_tiles", "mask_tiles"):
        (root / scene / kind).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        transform = (500000.0 + i * w * GSD, GSD, 0.0, 5600000.0, 0.0, -GSD)
        tiff.write(root / scene / "img_tiles" / f"{i:04d}.tif", images[i], transform, EPSG)
        tiff.write(root / scene / "mask_tiles" / f"{i:04d}.tif", masks[i][None], transform, EPSG)


def write_scene(path: Path, image: np.ndarray) -> None:
    """A (bands, H, W) uint8 scene as a GeoTIFF."""
    tiff.write(path, image, (500000.0, GSD, 0.0, 5600000.0, 0.0, -GSD), EPSG)


def seeds(seed: int, n: int) -> list:
    """``n`` independent seeds below 2**62 from the run's ``--seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(s) >> 2 for s in state]
