"""CLI front-end: ``python -m unet_tpu_torch serve <bundle> scene.tif out.tif``.

The ``serve`` subcommand takes the arguments of ``unet_tpu serve``, plus
``--device`` (default ``cuda``) and ``--stats-json`` (write the run's
timings and kernel launch counts to a JSON file). It computes in bf16.
The other subcommands come with later slices.
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
        description="aerial segmentation serving on NVIDIA GPUs (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

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


def _dispatch(args) -> int:
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
            "device_name": (torch.cuda.get_device_name(predictor.device)
                            if predictor.device.type == "cuda" else "cpu"),
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
