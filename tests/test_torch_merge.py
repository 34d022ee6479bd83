"""PyTorch port: the copied ``predict/merge.py`` against the JAX package's.

``tile_extent_info``, ``grid_layout`` and ``MosaicAccumulator`` (float32
and ``large_file`` int8 sums, every finalize mode, regression nodata) on
the same tiles and the same class stacks: bit-equal.
"""

import warnings

import numpy as np
import pytest

from unet_tpu.predict import merge as jm
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.predict import merge as tm

XRES, YRES = 0.2, -0.2
CRS = "EPSG:25832"


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Georeferenced tiles of 40² on a 100 × 130 scene at overlap, two of
    them 24 × 40 (a second tile shape), and each tile's class stack."""
    root = tmp_path_factory.mktemp("merge")
    rng = np.random.default_rng(0)
    specs = [(r, c, 40, 40) for r in (0, 30, 60) for c in (0, 30, 60, 90)]
    specs += [(76, 10, 24, 40), (76, 50, 24, 40)]
    paths, stacks = [], []
    for i, (r, c, h, w) in enumerate(specs):
        p = root / f"t_{i}.tif"
        t = (500000.0 + XRES * c, XRES, 0.0, 5400000.0 + YRES * r, 0.0, YRES)
        write_raster(p, np.zeros((1, h, w), np.uint8), transform=t, crs=CRS)
        paths.append(str(p))
        stacks.append(rng.dirichlet(np.ones(3), size=(h, w)).transpose(2, 0, 1)
                      .astype(np.float32))
    return paths, stacks


def test_tile_extent_info_and_grid_layout_equal_jax(tiles):
    paths, _ = tiles
    infos_j = [jm.tile_extent_info(p) for p in paths]
    infos_t = [tm.tile_extent_info(p) for p in paths]
    assert [vars(i) for i in infos_t] == [vars(i) for i in infos_j]
    got, want = tm.grid_layout(infos_t), jm.grid_layout(infos_j)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype == np.int32
    assert got[2:] == want[2:] == (100, 130, (500000.0, XRES, 0.0, 5400000.0, 0.0, YRES))


MODES = {"argmax": {}, "all_classes": {"all_classes": True},
         "specific_class": {"specific_class": 2}, "regression": {"regression": True}}


# large_file holds stretched int8 probabilities, never regression values
CASES = [(mode, False) for mode in sorted(MODES)] + [
    (mode, True) for mode in sorted(MODES) if mode != "regression"]
GAP = 5  # the tile at (30, 30): left out, its centre is covered by no other


@pytest.mark.parametrize("mode,large_file", CASES)
def test_mosaic_accumulator_bit_equal_to_jax(tiles, mode, large_file):
    paths, stacks = tiles
    kept = [i for i in range(len(paths)) if i != GAP]
    accs = [m.MosaicAccumulator([m.tile_extent_info(paths[i]) for i in kept],
                                large_file=large_file) for m in (jm, tm)]
    for i in kept:
        p, s = paths[i], stacks[i]
        s = s[:1] * 7 if mode == "regression" else s
        if large_file:
            s = np.around(s * 31).astype(np.int8)
        for acc in accs:
            acc.add(s, p)
    (want, wt, wn), (got, gt, gn) = (a.finalize(**MODES[mode]) for a in accs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert gt == wt and gn == wn
    if mode == "regression":
        assert gn == -9999 and (got == -9999).any()


def test_finalize_mosaic_equals_jax(tiles):
    rng = np.random.default_rng(1)
    summed = rng.uniform(0, 3, (3, 20, 30)).astype(np.float32)
    counter = rng.integers(0, 4, (20, 30)).astype(np.float32)
    for kw in MODES.values():
        got, gn = tm.finalize_mosaic(summed, counter, **kw)
        want, wn = jm.finalize_mosaic(summed, counter, **kw)
        np.testing.assert_array_equal(got, want)
        assert gn == wn


def test_mixed_crs_and_resolution_warn_like_jax(tiles):
    paths, _ = tiles
    infos = [tm.tile_extent_info(p) for p in paths[:2]]
    infos[1].crs, infos[1].xres = "EPSG:4326", 0.5
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tm.MosaicAccumulator(infos)
    assert [str(w.message) for w in rec] == [
        "Geoprojection is not the same for all prediction tiles.",
        "Not all tiles have the same resolution."]
    with pytest.raises(ValueError, match="No tiles"):
        tm.MosaicAccumulator([])
