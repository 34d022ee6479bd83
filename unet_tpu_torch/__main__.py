"""CLI front-end: ``python -m unet_tpu_torch <train|serve|doctor> ...``.

    python -m unet_tpu_torch train tiles/ --model-path models --description run1 ...
    python -m unet_tpu_torch serve models/run1 scene.tif out.tif
    python -m unet_tpu_torch doctor [--kernels]

Each subcommand takes the arguments of its ``unet_tpu`` counterpart.
``train`` and ``serve`` also take ``--device`` (default ``cuda``) and
``--stats-json`` (write the run's timings, kernel launch counts and, for
``train``, the loader's decode path to a JSON file); both compute in bf16.
``doctor`` checks whether this machine is ready: versions, the CUDA
device, the nvcc toolchain, the native decoder and, with ``--kernels``
(also spelled ``--pallas``, as in ``unet_tpu``), every CUDA kernel against
its plain version; it exits 0 only when every check passes. Arguments
whose feature is not ported yet exit with "not yet ported" instead of
being ignored. The other subcommands come with later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="unet_tpu_torch",
        description="aerial segmentation training and serving on NVIDIA GPUs "
                    "(PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="train a model on a tile dataset")
    tr.add_argument("data_path")
    tr.add_argument("--model-path", required=True)
    tr.add_argument("--description", default="model")
    tr.add_argument("--codes", nargs="+", default=["Background", "Class_1"])
    tr.add_argument("--arch", default="xresnet34")
    tr.add_argument("--batch-size", type=int, default=4)
    tr.add_argument("--epochs", type=int, default=15)
    tr.add_argument("--lr", type=float, default=1e-4)
    tr.add_argument("--regression", action="store_true", help="not yet ported")
    tr.add_argument("--class-weights", default="even")
    tr.add_argument("--self-attention", action="store_true", help="not yet ported")
    tr.add_argument("--existing-model", default=None, help="not yet ported")
    tr.add_argument("--lr-finder", default=None, help="not yet ported")
    tr.add_argument("--pretrained-weights", default=None, help="not yet ported")
    tr.add_argument("--tpu-opt", action=argparse.BooleanOptionalAction, default=True,
                    help="the tpu_opt topology (--no-tpu-opt: not yet ported)")
    tr.add_argument("--grad-accum", type=int, default=1, help="> 1: not yet ported")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--reference-quirks", action="store_true", help="not yet ported")
    tr.add_argument("--profile-dir", default=None, help="not yet ported")
    tr.add_argument("--coordinator", default=None, help="not yet ported")
    tr.add_argument("--num-processes", type=int, default=None, help="not yet ported")
    tr.add_argument("--process-id", type=int, default=None, help="not yet ported")
    tr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    tr.add_argument("--stats-json", default=None,
                    help="write steps, seconds, tiles/s, step ms and kernel "
                         "launch counts here")

    sv = sub.add_parser("serve", help="predict whole GeoTIFFs directly (no tile files)")
    sv.add_argument("model")
    sv.add_argument("raster", nargs="+",
                    help="one or more scene GeoTIFFs; with several, OUTPUT "
                         "is a directory and the model stays resident")
    sv.add_argument("output")
    sv.add_argument("--patch-size", type=int, default=None)
    sv.add_argument("--patch-overlap", type=float, default=0.2)
    sv.add_argument("--batch-size", type=int, default=16)
    sv.add_argument("--regression", action="store_true")
    sv.add_argument("--all-classes", action="store_true")
    sv.add_argument("--specific-class", type=int, default=None)
    sv.add_argument("--class-zero", action="store_true",
                    help="0 = nodata: decrement classes on write")
    sv.add_argument("--spatial", type=int, default=1,
                    help="shard patch height over devices (not yet ported)")
    sv.add_argument("--tta", action="store_true",
                    help="4-fold flip test-time augmentation (averaged "
                         "probabilities; 4x forward cost)")
    sv.add_argument("--compress", default=None,
                    choices=["none", "deflate", "lzw", "packbits", "jpeg", "jpeg-lossless"],
                    help="output mosaic compression")
    sv.add_argument("--stream", action="store_true",
                    help="O(band)-memory streamed path (not yet ported)")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    sv.add_argument("--stats-json", default=None,
                    help="write windows, batches, seconds, tiles/s, forward "
                         "ms per batch and kernel launch counts here")

    dr = sub.add_parser("doctor", help="diagnose the environment: versions, CUDA "
                                       "device, nvcc, native decoder, kernels")
    dr.add_argument("--kernels", "--pallas", dest="kernels", action="store_true",
                    help="also build every CUDA kernel and check it against its "
                         "plain version on the card")
    return ap


def cli(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.environ.get("UNET_TPU_TRACEBACK"):
        return _dispatch(args)
    try:
        return _dispatch(args)
    except (OSError, ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        print("(set UNET_TPU_TRACEBACK=1 for the full traceback)", file=sys.stderr)
        return 2


def train_kernel_launches() -> dict:
    """Launch count of each CUDA kernel of the train path in this process."""
    from .ops.aug import fused_flip_scale
    from .ops.bn import bn_bwd_sums, bn_sum_sumsq

    return {"bn_sum_sumsq": bn_sum_sumsq.launches,
            "bn_bwd_sums": bn_bwd_sums.launches,
            "flip_scale": fused_flip_scale.launches}


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _dispatch(args) -> int:
    if args.command == "doctor":
        from .utils.doctor import run_doctor

        results = run_doctor(kernels=args.kernels)
        return 0 if all(ok for ok, _ in results.values()) else 1
    return _train(args) if args.command == "train" else _serve(args)


UNPORTED_TRAIN_ARGS = (
    ("regression", "--regression"), ("self_attention", "--self-attention"),
    ("existing_model", "--existing-model"), ("lr_finder", "--lr-finder"),
    ("pretrained_weights", "--pretrained-weights"),
    ("reference_quirks", "--reference-quirks"), ("profile_dir", "--profile-dir"),
    ("coordinator", "--coordinator"), ("num_processes", "--num-processes"),
    ("process_id", "--process-id"))


def _train(args) -> int:
    from .train.loop import Trainer, TrainerConfig, train_model

    for attr, flag in UNPORTED_TRAIN_ARGS:
        if getattr(args, attr) is not None and getattr(args, attr) is not False:
            raise NotImplementedError(f"{flag} is not yet ported")
    if not args.tpu_opt:
        raise NotImplementedError("--no-tpu-opt (the parity topology) is not yet ported")
    if args.grad_accum > 1:
        raise NotImplementedError("--grad-accum > 1 is not yet ported")
    cw = args.class_weights
    if cw not in ("even", "weighted"):
        cw = json.loads(cw)
    cfg = TrainerConfig(data_path=args.data_path, model_path=args.model_path,
                        description=args.description, codes=args.codes,
                        arch=args.arch, batch_size=args.batch_size,
                        epochs=args.epochs, lr=args.lr, class_weights=cw,
                        seed=args.seed, device=args.device)
    trainer = Trainer(cfg)
    t0 = time.perf_counter()
    out = train_model(cfg, trainer)
    seconds = time.perf_counter() - t0
    print(f"Model bundle exported to {out}")
    if args.stats_json:
        step_ms = trainer.step_ms()
        stats = {
            "device": str(trainer.device),
            "device_name": _device_name(trainer.device),
            "steps": len(step_ms),
            "batch_size": cfg.batch_size,
            "seconds": seconds,
            "train_tiles_per_s": len(step_ms) * cfg.batch_size / seconds,
            "step_ms": step_ms,
            "history": trainer.history,
            "launches": train_kernel_launches(),
            "loader": {"path": trainer.train_loader.path,
                       "first_batch_ms": trainer.train_loader.first_batch_ms},
        }
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _serve(args) -> int:
    import torch

    from .ops.blend import blend_and_count
    from .predict.predict import Predictor, predict_raster, serve_scenes
    from .tiling.windows import generate_windows
    from .geo import tiff

    if args.spatial > 1:
        raise NotImplementedError("--spatial > 1 is not yet ported")
    if args.stream:
        raise NotImplementedError("--stream is not yet ported")
    compress = None if args.compress in (None, "none") else args.compress
    predictor = Predictor(args.model, batch_size=args.batch_size,
                          device=args.device, dtype=torch.bfloat16, tta=args.tta)
    common = dict(patch_size=args.patch_size, patch_overlap=args.patch_overlap,
                  batch_size=args.batch_size, regression=args.regression,
                  all_classes=args.all_classes,
                  specific_class=args.specific_class,
                  class_zero=args.class_zero, tta=args.tta,
                  predictor=predictor, out_compress=compress,
                  device=predictor.device, dtype=predictor.dtype)
    t0 = time.perf_counter()
    if len(args.raster) > 1:
        outs = serve_scenes(args.model, args.raster, args.output, **common)
        print(f"{len(outs)} mosaics in {args.output}")
    else:
        arr, _, _ = predict_raster(args.model, args.raster[0], args.output, **common)
        print(f"Mosaic {arr.shape} written to {args.output}")
    seconds = time.perf_counter() - t0
    if args.stats_json:
        patch = int(args.patch_size or predictor.manifest.get("patch_size", 400))
        n_windows = n_batches = 0
        for rp in args.raster:
            info = tiff.read_info(rp)
            n = len(generate_windows(info.height, info.width, patch,
                                     args.patch_overlap))
            n_windows += n
            n_batches += -(-n // args.batch_size)
        stats = {
            "device": str(predictor.device),
            "device_name": _device_name(predictor.device),
            "windows": n_windows,
            "batches": n_batches,
            "seconds": seconds,
            "tiles_per_s": n_windows / seconds,
            "forward_ms": predictor.forward_ms(),
            "launches": {"blend_count": blend_and_count.launches},
        }
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
