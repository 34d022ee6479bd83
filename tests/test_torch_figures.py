"""PyTorch port: the validation figures (``predict/figures.py``) and
``predict --validation-vision`` against the JAX package's and sklearn's
on the CPU.

The confusion matrix and the classification report text equal sklearn's
(``zero_division=1``) without the port importing sklearn; on the same
tile folder ``plot_valid_predict`` returns and prints what JAX's does and
writes byte-equal heatmaps; merge and regression raise as in JAX. Through
the CLI, ``predict --validation-vision`` prints the matrix and draws the
figures, and without matplotlib prints the matrix and draws none.
"""

import shutil
import sys

import numpy as np
import pytest
import torch
from sklearn.metrics import classification_report as sk_report
from sklearn.metrics import confusion_matrix as sk_confusion

from unet_tpu.predict import figures as jax_figures
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
from unet_tpu_torch.predict import figures
from unet_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)
TILE = 32
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25832"
LABELS = {
    "mixed": ([0, 1, 2, 2, 1, 0, 2, 1, 1, 0, 2, 2], [0, 2, 2, 2, 1, 1, 2, 0, 1, 0, 2, 1]),
    "missing_from_predictions": ([0, 1, 2, 3, 1, 2, 3, 3], [0, 1, 1, 1, 1, 2, 2, 1]),
    "only_in_predictions": ([1, 1, 2, 2, 1], [1, 4, 2, 2, 1]),
    "one_class": ([2, 2, 2, 2], [2, 2, 2, 2]),
    "none_right": ([4, 5, 4], [7, 4, 5]),
    "many": ([int(v) for v in np.random.default_rng(3).integers(0, 12, 200)],
             [int(v) for v in np.random.default_rng(4).integers(0, 12, 200)]),
}


@pytest.mark.parametrize("case", sorted(LABELS))
def test_matrix_and_report_equal_sklearn(case):
    y_true, y_pred = LABELS[case]
    labels, cm = figures.confusion_matrix(y_true, y_pred)
    want = sk_confusion(y_true, y_pred)
    assert cm.dtype == want.dtype
    np.testing.assert_array_equal(cm, want)
    np.testing.assert_array_equal(labels, sorted(set(y_true) | set(y_pred)))
    text, rows = figures.classification_report(y_true, y_pred, zero_division=1)
    assert text == sk_report(y_true, y_pred, zero_division=1)
    d = sk_report(y_true, y_pred, zero_division=1, output_dict=True)
    assert rows == [{"class": k, "precision": v["precision"], "recall": v["recall"],
                     "f1_score": v["f1-score"], "support": int(v["support"])}
                    for k, v in d.items() if isinstance(v, dict)
                    and k not in ("macro avg", "weighted avg")]


def _tile_folder(root, seed):
    """``img_tiles`` and ``mask_tiles`` of 10 tiles and a predicted folder
    beside: tile i's mask is mostly class i % 4 (0 is nodata under
    class_zero), its prediction mostly a seeded class; one predicted tile
    has no mask and one file is not a tif."""
    rng = np.random.default_rng(seed)
    for sub in ("img_tiles", "mask_tiles", "predicted_tiles_m"):
        (root / sub).mkdir(parents=True)
    for i in range(10):
        name = f"t_{i:02d}.tif"
        img = rng.integers(0, 256, (3, TILE, TILE)).astype(np.uint8)
        mask = np.full((TILE, TILE), i % 4, np.uint8)
        mask[: TILE // 3] = rng.integers(0, 4, (TILE // 3, TILE))
        pred = np.full((TILE, TILE), rng.integers(0, 3), np.uint8)
        pred[: TILE // 3] = rng.integers(0, 3, (TILE // 3, TILE))
        write_raster(root / "img_tiles" / name, img, transform=TRANSFORM, crs=CRS)
        write_raster(root / "mask_tiles" / name, mask[None], transform=TRANSFORM, crs=CRS)
        write_raster(root / "predicted_tiles_m" / name, pred[None], transform=TRANSFORM,
                     crs=CRS)
    write_raster(root / "predicted_tiles_m" / "no_mask.tif", np.zeros((1, 8, 8), np.uint8),
                 transform=TRANSFORM, crs=CRS)
    (root / "predicted_tiles_m" / "notes.txt").write_text("not a tile")
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The source tile folder; each test copies it per package."""
    root = tmp_path_factory.mktemp("figures")
    _tile_folder(root / "src", seed=1)
    return root


def _copy(root, side, class_zero):
    d = root / f"{side}_{int(class_zero)}"
    shutil.copytree(root / "src", d)
    return d


@pytest.mark.parametrize("class_zero", [False, True])
def test_plot_valid_predict_matches_jax(folders, class_zero, capsys):
    """The same matrix, report, printed lines and heatmap bytes as JAX's
    on the same folder; under class_zero the tiles whose mask is mostly 0
    drop out and the classes shift down."""
    results = {}
    for side, fn in (("jax", jax_figures.plot_valid_predict),
                     ("port", figures.plot_valid_predict)):
        d = _copy(folders, side, class_zero)
        results[side] = fn(str(d / "predicted_tiles_m"), str(d / "img_tiles"),
                           class_zero=class_zero) + (capsys.readouterr().out, d)
    (cm, report, out, d), (wcm, wreport, wout, wd) = results["port"], results["jax"]
    np.testing.assert_array_equal(cm, wcm)
    assert cm.dtype == wcm.dtype and report == wreport and out == wout
    assert "Figure rendering failed" not in out
    assert int(cm.sum()) == (7 if class_zero else 10)
    for name in ("classification_report.png", "Confusion_Matrix.png"):
        got = d / "predicted_tiles_m" / "Valid_figures" / name
        assert got.read_bytes() == (wd / "predicted_tiles_m" / "Valid_figures" / name
                                    ).read_bytes()


@pytest.mark.parametrize("kw,match", [({"merge": True}, "merged tiles"),
                                      ({"regression": True}, "classification problems")])
def test_merge_and_regression_raise_as_in_jax(folders, kw, match):
    d = folders / "src"
    for fn in (figures.plot_valid_predict, jax_figures.plot_valid_predict):
        with pytest.raises(ValueError, match=match):
            fn(str(d / "predicted_tiles_m"), str(d / "img_tiles"), **kw)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A seeded xresnet18 bundle of 3 classes for 32² tiles."""
    root = tmp_path_factory.mktemp("figures_bundle")
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                         torch.Generator().manual_seed(0))
    ckpt.export_bundle(root / "m", "m", ckpt.to_flax_variables(model.state_dict()),
                       {"ARCHITECTURE": "xresnet18", "tpu_opt": True, "self_attention": False,
                        "n_out": 3, "number_of_bands": 3, "patch_size": TILE,
                        "enable_regression": False, "dtype_str": "uint8",
                        "normalize": "unit", "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION})
    return root / "m"


@pytest.mark.parametrize("plotting", [True, False])
def test_predict_validation_vision_through_the_cli(bundle, tmp_path, plotting, monkeypatch,
                                                   capsys):
    """``predict --validation-vision`` in tiles mode: exit 0, the matrix
    (summing to the 10 tiles with masks) and the report printed; the two
    figures drawn, or, with matplotlib hidden, one line naming it and no
    PNG."""
    d = _tile_folder(tmp_path, seed=2)
    shutil.rmtree(d / "predicted_tiles_m")
    if not plotting:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert cli(["predict", str(bundle), str(d / "img_tiles"), "--validation-vision",
                "--batch-size", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Confusion Matrix:" in out and "Classification Report:" in out
    valid = d / "predicted_tiles_m" / "Valid_figures"
    y_true, y_pred = figures.tile_majorities(d / "predicted_tiles_m", d / "img_tiles")
    assert len(y_true) == 10
    assert sk_report(y_true, y_pred, zero_division=1) in out
    pngs = sorted(p.name for p in valid.glob("*.png")) if valid.exists() else []
    if plotting:
        assert pngs == ["Confusion_Matrix.png", "classification_report.png"]
    else:
        assert pngs == []
        # seaborn, which imports matplotlib, is missing too unless imported before
        assert f"{valid}: figures skipped, matplotlib" in out
