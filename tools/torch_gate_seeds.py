"""The quality gate of ``tests/test_quality_parity.py`` through the PyTorch
port, for chosen seeds and numerics: how far a seed's outcome follows the
float summation order.

    python tools/torch_gate_seeds.py --device cpu --threads 1 2 3 4 --seeds 2
    python tools/torch_gate_seeds.py --device cuda --seeds 2 --tf32 on off --bf16

Each run is the gate's configuration field for field (the fixture's 384²
scene, 128² tiles, xresnet18, batch 4, lr 3e-3, weighted focal loss,
flips, tpu_opt at 20 epochs, or parity at 14 with ``--parity``); it prints
one line per run with the best validation dice and the mosaic mIoU. On
the CPU each thread count runs in its own process (``torch.set_num_threads``
there), all at once; on the card the runs go one after another, with
cuDNN's TF32 as asked and, with ``--bf16``, once more in bf16. Imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import importlib.util
import io
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
T = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CODES = ["nodata", "ground", "trees", "buildings", "water"]


def run(seed: int, tpu_opt: bool, device: str, bf16: bool, root: Path) -> tuple:
    """(best validation dice, mosaic mIoU) of one gate run under ``root``."""
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.predict import save_predictions
    from unet_tpu_torch.tiling import split_raster
    from unet_tpu_torch.train.loop import TrainerConfig, train_model

    spec = importlib.util.spec_from_file_location("aerial_fixture",
                                                  ROOT / "tests" / "aerial_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    img, cls = fixture.make_scene(384, seed=4)
    write_raster(root / "scene.tif", img, transform=T, crs="EPSG:25833")
    write_raster(root / "mask.tif", cls[None], transform=T, crs="EPSG:25833")
    split_raster(str(root / "scene.tif"), str(root / "mask.tif"), str(root / "tiles"),
                 patch_size=128, patch_overlap=0.2, split=[0.8, 0.2], max_empty=0.9, seed=1)
    split_raster(str(root / "scene.tif"), None, str(root / "pred"), patch_size=128,
                 patch_overlap=0.2, max_empty=1.0)
    with contextlib.redirect_stdout(io.StringIO()):
        bundle = train_model(TrainerConfig(
            data_path=root / "tiles", model_path=root / "models", description="gate",
            batch_size=4, epochs=20 if tpu_opt else 14, lr=3e-3, arch="xresnet18",
            codes=CODES, class_weights="weighted", loss_func="focal", bf16=bf16, seed=seed,
            transforms=True, tpu_opt=tpu_opt, device=device))
        out = save_predictions(str(bundle), str(root / "pred" / "img_tiles"), merge=True,
                               batch_size=4, device=device)
    rows = (bundle / "gate_history.csv").read_text().splitlines()
    col = rows[0].split(",").index("dice_multi")
    dice = max(float(r.split(",")[col]) for r in rows[1:])
    return dice, fixture.class_iou(read_raster(out).data[0], cls, len(CODES))[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cpu", "cuda"], required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--parity", action="store_true", help="the parity topology, 14 epochs")
    ap.add_argument("--threads", type=int, nargs="+", default=[2], help="CPU thread counts")
    ap.add_argument("--tf32", choices=["on", "off"], nargs="+", default=["on"],
                    help="cuDNN's TF32 for the float32 runs on the card")
    ap.add_argument("--bf16", action="store_true", help="also a bf16 run of each seed")
    ap.add_argument("--one", nargs=2, type=int, metavar=("SEED", "THREADS"),
                    help=argparse.SUPPRESS)  # one CPU run in this process
    args = ap.parse_args()
    topology = "parity" if args.parity else "tpu_opt"
    if args.one:
        import torch

        seed, threads = args.one
        torch.set_num_threads(threads)
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_gate_") as tmp:
            dice, miou = run(seed, not args.parity, "cpu", False, Path(tmp))
        print(f"{topology} seed {seed} cpu, {threads} threads, float32: dice {dice:.4f}, "
              f"mosaic mIoU {miou:.4f}", flush=True)
        return 0
    if args.device == "cpu":
        jobs = [(s, t) for s in args.seeds for t in args.threads]
        cmd = [sys.executable, __file__, "--device", "cpu"] + (["--parity"] if args.parity else [])
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            procs = [pool.submit(subprocess.run, cmd + ["--one", str(s), str(t)],
                                 capture_output=True, text=True, check=True)
                     for s, t in jobs]
            for p in procs:
                print(p.result().stdout.strip().splitlines()[-1], flush=True)
        return 0
    import torch

    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    runs = [(s, tf32, False) for s in args.seeds for tf32 in args.tf32]
    runs += [(s, "on", True) for s in args.seeds] if args.bf16 else []
    for seed, tf32, bf16 in runs:
        torch.backends.cudnn.allow_tf32 = tf32 == "on"
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_gate_") as tmp:
            dice, miou = run(seed, not args.parity, "cuda", bf16, Path(tmp))
        print(f"{topology} seed {seed} cuda, {'bf16' if bf16 else 'float32'}, cuDNN TF32 "
              f"{tf32}: dice {dice:.4f}, mosaic mIoU {miou:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
