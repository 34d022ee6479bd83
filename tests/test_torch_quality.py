"""PyTorch port: the quality gate of ``tests/test_quality_parity.py``,
through the port on the CPU, field for field.

The same synthetic aerial scene (``make_scene(384, seed=4)``), cut by the
port's ``split_raster`` (128² tiles, overlap 0.2, split 0.8/0.2,
``max_empty`` 0.9, seed 1; the prediction tiles with no mask and
``max_empty`` 1.0), trained by the port (xresnet18, batch 4, lr 3e-3,
weighted focal loss, flips, float32) and merged by the port's
``save_predictions(merge=True)``. The floors are the JAX gate's: parity
dice >= .93 and mIoU >= .93 at 14 epochs; tpu_opt dice >= .90 and mIoU
>= .93 at 20 epochs on each of seeds 0-2. Marked ``slow``: about four
and a half minutes on 2 CPU threads.
"""

import csv

import numpy as np
import pytest
import torch

from aerial_fixture import class_iou, make_scene
from unet_tpu_torch.data import resolve_class_weights
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.predict import save_predictions
from unet_tpu_torch.tiling import split_raster
from unet_tpu_torch.train.loop import TrainerConfig, train_model

T = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
SIZE, TILE = 384, 128
CODES = ["nodata", "ground", "trees", "buildings", "water"]
PARITY_DICE_FLOOR = PARITY_MIOU_FLOOR = 0.93
TPU_OPT_DICE_FLOOR, TPU_OPT_MIOU_FLOOR = 0.90, 0.93
TPU_OPT_EPOCHS, TPU_OPT_SEEDS = 20, (0, 1, 2)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def aerial_scene(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("aerial")
    img, cls = make_scene(SIZE, seed=4)
    ip, mp = root / "scene.tif", root / "mask.tif"
    write_raster(ip, img, transform=T, crs="EPSG:25833")
    write_raster(mp, cls[None], transform=T, crs="EPSG:25833")
    base = root / "tiles"
    n = split_raster(str(ip), str(mp), str(base), patch_size=TILE, patch_overlap=0.2,
                     split=[0.8, 0.2], max_empty=0.9, seed=1)
    assert n >= 9
    pred_base = root / "pred"
    split_raster(str(ip), None, str(pred_base), patch_size=TILE, patch_overlap=0.2,
                 max_empty=1.0)
    return root, cls, base, pred_base


def _train_and_mosaic(aerial_scene, desc, *, seed, epochs, tpu_opt):
    root, cls, base, pred_base = aerial_scene
    bundle = train_model(TrainerConfig(
        data_path=base, model_path=root / "models", description=desc, batch_size=4,
        epochs=epochs, lr=3e-3, arch="xresnet18", codes=CODES, class_weights="weighted",
        loss_func="focal", bf16=False, seed=seed, transforms=True, tpu_opt=tpu_opt,
        device="cpu"))
    rows = list(csv.DictReader((bundle / f"{desc}_history.csv").open()))
    best_dice = max(float(r["dice_multi"]) for r in rows)
    out = save_predictions(str(bundle), str(pred_base / "img_tiles"), merge=True,
                           AOI=desc, year="2026", batch_size=4, device="cpu")
    pred = read_raster(out).data[0]
    assert pred.shape == cls.shape
    ious, miou = class_iou(pred, cls, len(CODES))
    detail = {CODES[c]: round(float(v), 3) for c, v in ious.items()}
    print(f"\n{desc}: dice={best_dice:.3f} mosaic mIoU={miou:.3f} per-class={detail}")
    return best_dice, miou, detail


def test_parity_topology_floors(aerial_scene):
    dice, miou, detail = _train_and_mosaic(aerial_scene, "aerial", seed=0, epochs=14,
                                           tpu_opt=False)
    assert dice >= PARITY_DICE_FLOOR, f"parity dice {dice} below floor"
    assert miou >= PARITY_MIOU_FLOOR, f"parity mIoU {miou:.3f} below floor ({detail})"


@pytest.mark.parametrize("seed", TPU_OPT_SEEDS)
def test_tpu_opt_matches_floors(aerial_scene, seed):
    dice, miou, detail = _train_and_mosaic(aerial_scene, f"aerial_tpu_s{seed}", seed=seed,
                                           epochs=TPU_OPT_EPOCHS, tpu_opt=True)
    assert dice >= TPU_OPT_DICE_FLOOR, f"tpu_opt seed {seed} dice {dice} below floor"
    assert miou >= TPU_OPT_MIOU_FLOOR, \
        f"tpu_opt seed {seed} mIoU {miou:.3f} below floor ({detail})"


def test_weighted_weights_reflect_imbalance(aerial_scene):
    w = resolve_class_weights("weighted", CODES, aerial_scene[2])
    assert len(w) == len(CODES) and all(np.isfinite(v) and v >= 0 for v in w)
    assert w[CODES.index("water")] > 2 * w[CODES.index("ground")]
    assert w[CODES.index("buildings")] > w[CODES.index("ground")]
