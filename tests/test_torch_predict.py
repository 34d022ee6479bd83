"""PyTorch port: ``save_predictions`` and the ``predict`` CLI against the
JAX package's, on the same JAX-exported bundles and the same tile files.

Both sides predict in float32 (the JAX predictor rebuilt at float32, the
port with ``dtype=torch.float32``) on the CPU. Every output mode, the host
and the device merge (the plain blend on the CPU), a regression bundle,
two tile-shape groups and a partial last batch. File names, folders,
transforms, CRS and nodata are equal; probabilities within 1e-5 absolute,
regression values (raw outputs of magnitude ~3) within 1e-4 absolute, as
``tests/test_torch_serve.py`` holds them;
class maps equal except near ties (where JAX's two largest probabilities
lie within 1e-5), as ``tests/test_torch_serve.py`` holds them; int8
outputs within 1 and equal but for at most 1e-3 of the values (the ×31
stretch rounds the float32 probabilities, which differ in their last
bits).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.__main__ import cli as jax_cli
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models.unet import TPU_OPT_TOPOLOGY_VERSION
from unet_tpu.predict import predict as jax_predict
from unet_tpu.train.checkpoint import export_bundle as jax_export_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.tiling import split_raster

torch.set_num_threads(2)
H, W, PATCH, BATCH = 150, 182, 64, 5  # 12 tiles of 64²: batches of 5, 5, 2
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25832"
# (row, col) of the 32 × 64 tiles of "mixed", flush with the bottom edge:
# the merge extent takes its height from the tile with the lowest top
EXTRA = [(118, 20), (118, 96)]


def _randomize_stats(variables, rng):
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean":
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


def _bundle(root, name, n_out, regression, rng):
    model = jax_build_unet("xresnet18", n_out=n_out, c_in=3, dtype=jnp.float32,
                           tpu_opt=True)
    v = model.init(jax.random.PRNGKey(n_out), np.zeros((1, PATCH, PATCH, 3), np.float32),
                   train=False)
    manifest = {"ARCHITECTURE": "xresnet18", "n_out": n_out, "number_of_bands": 3,
                "patch_size": PATCH, "enable_regression": regression,
                "dtype_str": "uint8", "normalize": "unit", "self_attention": False,
                "tpu_opt": True, "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION}
    jax_export_bundle(root / name, name, _randomize_stats(v, rng), manifest)
    return str(root / name)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A classification and a regression bundle written by JAX; the tiles
    of a 150 × 182 scene (``tiles``: 12 of 64²) and the same plus two of
    32 × 64 (``mixed``); one float32 JAX predictor per bundle."""
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.default_rng(0)
    bundles = {"cls": _bundle(root, "m", 3, False, rng),
               "reg": _bundle(root, "r", 1, True, rng)}
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([127 + 100 * np.sin(yy / 9.0 + c) * np.cos(xx / 13.0 - c)
                    + rng.normal(0, 10, yy.shape) for c in range(3)])
    img = np.clip(img, 0, 255).astype(np.uint8)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs=CRS)
    assert split_raster(str(root / "scene.tif"), None, str(root / "tiles"),
                        patch_size=PATCH, patch_overlap=0.2, max_empty=1.0) == 12
    shutil.copytree(root / "tiles", root / "mixed")
    shutil.copytree(root / "tiles", root / "short")
    for folder, rc in (("mixed", EXTRA), ("short", [(100, 20)])):
        for i, (r, c) in enumerate(rc):
            t = (TRANSFORM[0] + 0.2 * c, 0.2, 0.0, TRANSFORM[3] - 0.2 * r, 0.0, -0.2)
            write_raster(root / folder / "img_tiles" / f"extra_{i}.tif",
                         img[:, r:r + 32, c:c + PATCH], transform=t, crs=CRS)
    jax_preds = {}
    for kind, bundle in bundles.items():
        p = jax_predict.Predictor(bundle, batch_size=BATCH, devices=jax.devices()[:1])
        m = p.manifest
        p.model = jax_build_unet("xresnet18", n_out=m["n_out"], c_in=3,
                                 dtype=jnp.float32, tpu_opt=True)
        jax_preds[kind] = p
    return {"root": root, "bundles": bundles, "jax": jax_preds, "margins": {}}


def _run(setup, tmp_path, side, tiles="tiles", kind="cls", **kw):
    """Copy a tile folder under ``tmp_path/side`` and predict it there."""
    src = tmp_path / side / tiles / "img_tiles"
    shutil.copytree(setup["root"] / tiles / "img_tiles", src)
    kw.setdefault("batch_size", BATCH)
    if side == "jax":
        return jax_predict.save_predictions(setup["bundles"][kind], str(src),
                                            predictor=setup["jax"][kind], **kw)
    return tp.save_predictions(setup["bundles"][kind], str(src), device="cpu",
                               dtype=torch.float32, **kw)


def _margins(setup, tmp_path, tiles, merge):
    """JAX's gap between the two largest probabilities: {tile file name:
    array}, or one array over the merged mosaic."""
    key = (tiles, merge)
    if key not in setup["margins"]:
        out = Path(_run(setup, tmp_path / "margins", "jax", tiles, all_classes=True,
                        merge=merge))
        gaps = {f.name: np.diff(np.sort(read_raster(f).data, axis=0)[-2:], axis=0)[0]
                for f in ([out] if merge else sorted(out.glob("*.tif")))}
        setup["margins"][key] = gaps[out.name] if merge else gaps
    return setup["margins"][key]


def _assert_like_jax(got: Path, want: Path, margin=None, atol=1e-5):
    g, w = read_raster(got), read_raster(want)
    assert got.name == want.name
    assert g.data.dtype == w.data.dtype and g.data.shape == w.data.shape
    assert tuple(g.transform) == tuple(w.transform) and g.crs == w.crs
    assert g.nodata == w.nodata
    if w.data.dtype == np.float32:
        np.testing.assert_allclose(g.data, w.data, rtol=0, atol=atol)
        return
    differ = g.data != w.data
    assert differ.mean() <= 1e-3, f"{got.name}: {differ.mean():.2e} differ"
    if w.data.dtype == np.int8:
        assert np.abs(g.data.astype(int) - w.data).max() <= 1
    elif margin is not None:
        assert np.all(margin[got.name][differ[0]] < 1e-5)


TILE_MODES = {
    "argmax": {},
    "class_zero": {"class_zero": True},
    "all_classes": {"all_classes": True},
    "specific_class": {"specific_class": 1},
    "large_file_default": {"large_file": True},
    "large_file_all_classes": {"large_file": True, "all_classes": True},
    "large_file_specific_class": {"large_file": True, "specific_class": 2},
    "quirks_specific_class_0": {"large_file": True, "specific_class": 0,
                                "reference_quirks": True},
    "compress_lzw": {"out_compress": "lzw", "class_zero": True},
}


@pytest.mark.parametrize("mode", sorted(TILE_MODES))
def test_tile_outputs_match_jax(setup, tmp_path, mode):
    kw = TILE_MODES[mode]
    want = Path(_run(setup, tmp_path, "jax", **kw))
    got = Path(_run(setup, tmp_path, "port", **kw))
    assert want.name == got.name == "predicted_tiles_m"
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "jax")
    names = sorted(p.name for p in want.glob("*.tif"))
    assert len(names) == 12 and sorted(p.name for p in got.glob("*.tif")) == names
    margin = _margins(setup, tmp_path, "tiles", False)
    for name in names:
        _assert_like_jax(got / name, want / name, margin)


MERGE_MODES = {
    "host": {},
    "host_all_classes": {"all_classes": True},
    "host_large_file": {"large_file": True},
    "host_class_zero_specific": {"class_zero": True, "specific_class": 2},
    "device": {"device_merge": True},
    "device_all_classes_large_file": {"device_merge": True, "all_classes": True,
                                      "large_file": True},
    "device_specific_class": {"device_merge": True, "specific_class": 0},
    "mixed_host": {"tiles": "mixed"},
    "mixed_device": {"tiles": "mixed", "device_merge": True},
}


@pytest.mark.parametrize("mode", sorted(MERGE_MODES))
def test_merged_mosaic_matches_jax(setup, tmp_path, mode):
    kw = dict(MERGE_MODES[mode], merge=True, AOI="aoi", year="2026")
    want = Path(_run(setup, tmp_path, "jax", **kw))
    got = Path(_run(setup, tmp_path, "port", **kw))
    assert got.name == want.name == "aoi_2026_m_prediction.tif"
    assert got.parent == tmp_path / "port" / kw.get("tiles", "tiles")
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "jax")
    margin = _margins(setup, tmp_path, kw.get("tiles", "tiles"), True)
    # large_file sums int8 stretches: its ties are exact, not near
    _assert_like_jax(got, want, None if kw.get("large_file") else {got.name: margin})
    if mode.startswith("mixed"):
        assert read_raster(got).data.shape[1:] == (H, W)


@pytest.mark.parametrize("kw", [{}, {"merge": True}, {"merge": True, "device_merge": True}],
                         ids=["tiles", "host_merge", "device_merge"])
def test_regression_bundle_matches_jax(setup, tmp_path, kw):
    want = Path(_run(setup, tmp_path, "jax", kind="reg", **kw))
    got = Path(_run(setup, tmp_path, "port", kind="reg", **kw))
    files = [(got, want)] if kw else [(got / p.name, p) for p in sorted(want.glob("*.tif"))]
    assert len(files) == (1 if kw else 12)
    for g, w in files:
        _assert_like_jax(g, w, atol=1e-4)
    if kw:
        assert read_raster(got).nodata == -9999


def test_an_extent_too_small_for_its_tiles_is_refused(setup, tmp_path):
    """The reference's extent takes its height from the tile with the
    lowest top (a 32-row tile at row 100 here), which leaves the 64² tiles
    at row 86 outside it. JAX's host merge and both of the port's merges
    raise; JAX's device merge pads its buffer to whole tiles and crops."""
    for side, kw in (("jax", {}), ("port", {}), ("port", {"device_merge": True})):
        with pytest.raises(ValueError):
            _run(setup, tmp_path / str(len(kw)), side, "short", merge=True, **kw)


def test_device_merge_equals_host_merge_on_the_cpu(setup, tmp_path):
    """Both merges add the same float32 probabilities in tile order."""
    kw = dict(merge=True, all_classes=True, AOI="a")
    host = read_raster(_run(setup, tmp_path / "h", "port", **kw)).data
    dev = read_raster(_run(setup, tmp_path / "d", "port", device_merge=True, **kw)).data
    np.testing.assert_array_equal(dev, host)


def _masks_beside(src):
    """A ``mask_tiles`` folder beside ``src`` (``img_tiles``): each tile's
    mask a seeded function of its image."""
    (src.parent / "mask_tiles").mkdir()
    for f in sorted(src.glob("*.tif")):
        r = read_raster(f)
        mask = np.where(r.data[0] > 150, 1, np.where(r.data[1] > 150, 2, 0)).astype(np.uint8)
        write_raster(src.parent / "mask_tiles" / f.name, mask[None], transform=r.transform,
                     crs=r.crs)


def test_resident_predictor_and_unported_arguments(setup, tmp_path, capsys):
    """A resident predictor merges as a fresh one does; with masks beside
    the tiles, ``validation_vision`` prints the tile-majority matrix (over
    the 12 tiles) and report of the written tiles and draws the figures;
    ``spatial`` > 1 outside a process group of as many ranks raises,
    naming the launcher."""
    pred = tp.Predictor(setup["bundles"]["cls"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32)
    src = tmp_path / "t" / "img_tiles"
    shutil.copytree(setup["root"] / "tiles" / "img_tiles", src)
    a = tp.save_predictions(setup["bundles"]["cls"], str(src), merge=True, predictor=pred)
    b = tp.save_predictions(setup["bundles"]["cls"], str(src), merge=True,
                            device="cpu", dtype=torch.float32)
    assert a == b
    _masks_beside(src)
    capsys.readouterr()
    out_dir = tp.save_predictions(setup["bundles"]["cls"], str(src), predictor=pred,
                                  validation_vision=True)
    out = capsys.readouterr().out
    from sklearn.metrics import classification_report, confusion_matrix

    from unet_tpu_torch.predict.figures import tile_majorities

    y_true, y_pred = tile_majorities(out_dir, src)
    assert len(y_true) == 12
    assert f"Confusion Matrix:\n{confusion_matrix(y_true, y_pred)}\n" in out
    assert classification_report(y_true, y_pred, zero_division=1) in out
    assert sorted(p.name for p in (out_dir / "Valid_figures").glob("*.png")) == [
        "Confusion_Matrix.png", "classification_report.png"]
    with pytest.raises(ValueError, match="spatial=2 needs that many devices, have 1.*launch"):
        tp.save_predictions(setup["bundles"]["cls"], str(src), device="cpu", spatial=2)
    with pytest.raises(ValueError, match="requires uint8"):
        tp.save_predictions(setup["bundles"]["cls"], str(src), large_file=True,
                            out_compress="jpeg", device="cpu")


def test_save_predictions_needs_cuda_unless_cpu_is_asked(setup, tmp_path, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.save_predictions(setup["bundles"]["cls"], str(setup["root"] / "tiles" / "img_tiles"))
    assert cli(["predict", setup["bundles"]["cls"],
                str(setup["root"] / "tiles" / "img_tiles")]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_predict_cli_matches_jax_cli(setup, tmp_path, capsys):
    """Both CLIs in bf16 on the same bundle: the same mosaic file and
    georeference, class maps >= 99% equal."""
    outs = {}
    for side, fn, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
        src = tmp_path / side / "img_tiles"
        shutil.copytree(setup["root"] / "tiles" / "img_tiles", src)
        assert fn(["predict", setup["bundles"]["cls"], str(src), "--merge", "--aoi", "a",
                   "--year", "2026", "--batch-size", "4", "--compress", "deflate",
                   *extra]) == 0
        outs[side] = tmp_path / side / "a_2026_m_prediction.tif"
        assert f"Predictions at {outs[side]}" in capsys.readouterr().out
    g, w = read_raster(outs["port"]), read_raster(outs["jax"])
    assert g.data.dtype == w.data.dtype == np.uint8 and g.data.shape == (1, H, W)
    assert tuple(g.transform) == tuple(w.transform) == TRANSFORM and g.crs == w.crs == CRS
    assert (g.data == w.data).mean() >= 0.99


@pytest.mark.parametrize("flag", [["--validation-vision"], ["--spatial", "2"], ["uta"]])
def test_cli_unported_predict_options_fail_clearly(setup, tmp_path, flag, capsys):
    """Unported options, and a ``.uta`` model whose header is not an
    artifact's, exit 2 with one clear line. ``--validation-vision``, ported
    since, exits 0 and prints the matrix of the tiles with masks beside;
    ``--spatial 2``, ported since, starts two gloo ranks on the CPU, exits
    0 and writes tiles >= 99% equal to one process's (bf16; JAX's bar)."""
    model, said = setup["bundles"]["cls"], "not yet ported"
    tiles = setup["root"] / "tiles" / "img_tiles"
    if flag == ["--validation-vision"]:
        tiles = tmp_path / "v" / "img_tiles"
        shutil.copytree(setup["root"] / "tiles" / "img_tiles", tiles)
        _masks_beside(tiles)
        assert cli(["predict", model, str(tiles), "--device", "cpu", *flag]) == 0
        out = capsys.readouterr().out
        assert "Confusion Matrix:" in out and "Classification Report:" in out
        assert (tiles.parent / "predicted_tiles_m" / "Valid_figures").is_dir()
        return
    if flag == ["--spatial", "2"]:
        outs = []
        for extra in ([], flag):
            tiles = tmp_path / f"s{len(extra)}" / "img_tiles"
            shutil.copytree(setup["root"] / "tiles" / "img_tiles", tiles)
            assert cli(["predict", model, str(tiles), "--device", "cpu", "--batch-size",
                        str(BATCH), *extra]) == 0
            outs.append(sorted((tiles.parent / "predicted_tiles_m").glob("*.tif")))
        assert [p.name for p in outs[0]] == [p.name for p in outs[1]] and len(outs[0]) == 12
        same = [(read_raster(a).data == read_raster(b).data).mean() for a, b in zip(*outs)]
        assert np.mean(same) >= 0.99
        return
    if flag == ["uta"]:
        model, flag, said = str(tmp_path / "model.uta"), [], "not a readable serving artifact"
        with open(model, "wb") as f:
            np.savez(f, __utaot__=np.zeros(1, np.uint8))
    assert cli(["predict", model, str(tiles), "--device", "cpu", *flag]) == 2
    assert said in capsys.readouterr().err
