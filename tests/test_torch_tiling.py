"""PyTorch port: ``tiling/split.py`` and the ``tile`` CLI against the JAX
package. The same scene, mask and seed must give the same tile tree: the
same file names and the same bytes."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from unet_tpu.__main__ import cli as jax_cli
from unet_tpu.geo import write_raster as jax_write_raster
from unet_tpu.tiling import split_raster as jax_split_raster
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.tiling import SPLIT_DIRS, split_raster

T = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25833"


def tree(base: Path) -> dict:
    """{relative path: bytes} of every file under ``base``."""
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


def scene(root: Path, rng, size=120, bands=3, dtype=np.uint8, border=10,
          mask_transform=T, mask_shape=None, name="scene", nodata=0, transform=T):
    """An image and a mask GeoTIFF with a nodata border at the top."""
    hi = 4000 if dtype != np.uint8 else 255
    img = rng.integers(1, hi, size=(bands, size, size)).astype(dtype)
    mh, mw = mask_shape or (size, size)
    msk = rng.integers(1, 3, size=(1, mh, mw)).astype(np.uint8)
    img[:, :border, :] = 0
    msk[:, :border, :] = 0
    ip, mp = root / f"{name}.tif", root / f"{name}_mask.tif"
    write_raster(ip, img, transform=transform, crs=CRS, nodata=nodata)
    write_raster(mp, msk, transform=mask_transform, crs=CRS, nodata=nodata)
    return ip, mp


VARIANTS = {
    "default": ({}, {}),
    "class_zero": ({}, {"class_zero": True}),
    "no_mask": ({}, {"no_mask": True, "split": [1.0]}),
    "int16_to_uint16": ({"dtype": np.int16, "bands": 4}, {}),
    "uint16": ({"dtype": np.uint16, "bands": 5}, {}),
    "float32": ({"dtype": np.float32, "bands": 2}, {}),
    "shifted_mask": ({"mask_transform": (500002.0, 0.2, 0.0, 5399999.2, 0.0, -0.2),
                      "mask_shape": (112, 110)}, {}),
    "subpixel_mask": ({"mask_transform": (500000.06, 0.2, 0.0, 5399999.97, 0.0, -0.2)}, {}),
    "max_empty": ({"border": 40}, {"max_empty": 0.2}),
    "deflate": ({}, {"compress": "deflate"}),
    "lzw": ({}, {"compress": "lzw"}),
    "packbits": ({}, {"compress": "packbits"}),
    "jpeg": ({}, {"compress": "jpeg"}),
    "reference_quirks": ({"transform": (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.3),
                          "mask_transform": (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.3)},
                         {"reference_quirks": True}),
    "three_way_split": ({"border": 0}, {"split": [0.5, 0.3, 0.2], "seed": 5}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_split_raster_tree_equals_jax(tmp_path, variant):
    scene_kw, kw = VARIANTS[variant]
    kw = dict(kw)
    ip, mp = scene(tmp_path, np.random.default_rng(3), **scene_kw)
    mask = None if kw.pop("no_mask", False) else str(mp)
    args = dict(patch_size=40, patch_overlap=0.25, split=[0.8, 0.2], seed=7)
    args.update(kw)
    n_jax = jax_split_raster(str(ip), mask, str(tmp_path / "jax"), **args)
    n_port = split_raster(str(ip), mask, str(tmp_path / "port"), **args)
    assert n_port == n_jax > 0
    want = tree(tmp_path / "jax")
    assert len(want) >= n_jax
    assert tree(tmp_path / "port") == want


def test_golden_hash_of_the_jax_package(tmp_path):
    """The input of ``tests/test_tiling.py``'s golden test reproduces its
    pinned hash through the port."""
    rng = np.random.default_rng(20260816)
    img = rng.integers(1, 255, size=(3, 100, 100)).astype(np.uint8)
    msk = rng.integers(1, 3, size=(1, 100, 100)).astype(np.uint8)
    img[:, :15, :] = 0
    msk[:, :15, :] = 0
    ip, mp = tmp_path / "g.tif", tmp_path / "gm.tif"
    jax_write_raster(ip, img, transform=T, crs=CRS, nodata=0)
    jax_write_raster(mp, msk, transform=T, crs=CRS, nodata=0)
    base = tmp_path / "tiles"
    split_raster(str(ip), str(mp), str(base), patch_size=40, patch_overlap=0.25,
                 split=[1.0, 0.0], max_empty=0.5, seed=77)
    h = hashlib.sha256()
    for p in sorted(base.rglob("*.tif")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    assert h.hexdigest() == "75fe1bb07d5b4f6ba49e6dcb93c4dbfcb1ab4e18c374dec40166d29cc71c79b8"


def test_two_scenes_into_one_base_dir(tmp_path):
    rng = np.random.default_rng(4)
    scenes = [scene(tmp_path, rng, size=80, name=n) for n in ("sceneA", "sceneB")]
    for which, fn in (("jax", jax_split_raster), ("port", split_raster)):
        total = sum(fn(str(ip), str(mp), str(tmp_path / which), patch_size=40,
                       patch_overlap=0, split=[0.8, 0.2], seed=1) for ip, mp in scenes)
        assert total == 8
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert {p.parts[0] for p in map(Path, tree(tmp_path / "port"))} <= set(SPLIT_DIRS)


def test_unseeded_split_draws_from_numpy_global_state(tmp_path):
    ip, mp = scene(tmp_path, np.random.default_rng(5), border=0)
    for which, fn in (("jax", jax_split_raster), ("port", split_raster)):
        np.random.seed(11)
        fn(str(ip), str(mp), str(tmp_path / which), patch_size=40, patch_overlap=0,
           split=[0.5, 0.5])
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")


@pytest.mark.parametrize("extra", [[], ["--class-zero", "--compress", "lzw"],
                                   ["--split", "0.6", "0.2", "0.2", "--max-empty", "0.5"]])
def test_tile_cli_writes_the_jax_cli_tree(tmp_path, capsys, extra):
    ip, mp = scene(tmp_path, np.random.default_rng(6))
    outs = {}
    for which, fn in (("jax", jax_cli), ("port", cli)):
        base = tmp_path / which
        assert fn(["tile", str(ip), "--mask", str(mp), "--base-dir", str(base),
                   "--patch-size", "40", "--patch-overlap", "0.2", "--seed", "0",
                   *extra]) == 0
        outs[which] = capsys.readouterr().out.strip().splitlines()[-1]
    assert outs["port"] == outs["jax"].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert outs["port"].endswith(f"tiles written to {tmp_path / 'port'}")
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
