"""The quality gate of ``tests/test_quality_parity.py`` through the JAX
package on the CPU, for chosen seeds and core counts: how far a seed's
outcome follows the float summation order (XLA:CPU splits its reductions
by the cores it may use).

    python tools/jax_gate_seeds.py --seeds 2 --cores 1 4

Each run is the gate's configuration field for field (the fixture's 384²
scene, 128² tiles, xresnet18, batch 4, lr 3e-3, weighted focal loss,
flips, float32, tpu_opt at 20 epochs) on one JAX CPU device, in its own
process pinned to the first N cores; it prints the best validation dice
and the mosaic mIoU. ``tools/torch_gate_seeds.py`` is the PyTorch port's
counterpart.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CODES = ["nodata", "ground", "trees", "buildings", "water"]


def run(seed: int, root: Path) -> tuple:
    """(best validation dice, mosaic mIoU) of one gate run under ``root``."""
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from aerial_fixture import class_iou, make_scene
    from unet_tpu.geo import read_raster, write_raster
    from unet_tpu.predict import save_predictions
    from unet_tpu.tiling import split_raster
    from unet_tpu.train import TrainerConfig, train_model

    img, cls = make_scene(384, seed=4)
    write_raster(root / "scene.tif", img, transform=T, crs="EPSG:25833")
    write_raster(root / "mask.tif", cls[None], transform=T, crs="EPSG:25833")
    split_raster(str(root / "scene.tif"), str(root / "mask.tif"), str(root / "tiles"),
                 patch_size=128, patch_overlap=0.2, split=[0.8, 0.2], max_empty=0.9, seed=1)
    split_raster(str(root / "scene.tif"), None, str(root / "pred"), patch_size=128,
                 patch_overlap=0.2, max_empty=1.0)
    with contextlib.redirect_stdout(io.StringIO()):
        bundle = train_model(TrainerConfig(
            data_path=root / "tiles", model_path=root / "models", description="gate",
            batch_size=4, epochs=20, lr=3e-3, arch="xresnet18", codes=CODES,
            class_weights="weighted", loss_func="focal", bf16=False, seed=seed,
            transforms=True, tpu_opt=True))
        out = save_predictions(str(bundle), str(root / "pred" / "img_tiles"), merge=True,
                               batch_size=4)
    rows = (bundle / "gate_history.csv").read_text().splitlines()
    col = rows[0].split(",").index("dice_multi")
    dice = max(float(r.split(",")[col]) for r in rows[1:])
    return dice, class_iou(read_raster(out).data[0], cls, len(CODES))[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--cores", type=int, nargs="+", default=[4])
    ap.add_argument("--one", nargs=2, type=int, metavar=("SEED", "CORES"),
                    help=argparse.SUPPRESS)  # one run in this process
    args = ap.parse_args()
    if args.one:
        seed, cores = args.one
        os.sched_setaffinity(0, range(cores))
        os.environ["JAX_PLATFORMS"] = "cpu"
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_gate_") as tmp:
            dice, miou = run(seed, Path(tmp))
        print(f"JAX tpu_opt seed {seed} cpu, {cores} cores, float32: dice {dice:.4f}, "
              f"mosaic mIoU {miou:.4f}", flush=True)
        return 0
    jobs = [(s, c) for s in args.seeds for c in args.cores]
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        procs = [pool.submit(subprocess.run, [sys.executable, __file__, "--one", str(s), str(c)],
                             capture_output=True, text=True, check=True) for s, c in jobs]
        for p in procs:
            print(p.result().stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
