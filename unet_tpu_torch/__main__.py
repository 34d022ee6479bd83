"""CLI front-end: ``python -m unet_tpu_torch <run|tile|train|predict|serve|export|import-weights|import-model|doctor> ...``.

    python -m unet_tpu_torch run config.json [--multi] [--device cpu]
    python -m unet_tpu_torch tile scene.tif --mask mask.tif --base-dir tiles
    python -m unet_tpu_torch train tiles/ --model-path models --description run1 ...
    python -m unet_tpu_torch predict models/run1 pred/img_tiles --merge [--device-merge]
    python -m unet_tpu_torch serve models/run1 scene.tif out.tif [--stream]
    python -m unet_tpu_torch export models/run1 model.uta [--quantize int8]
    python -m unet_tpu_torch import-weights xresnet34.pth -o xresnet34.npz
    python -m unet_tpu_torch import-model model_sd.pth models/imported
    python -m unet_tpu_torch doctor [--kernels]

Each subcommand takes the arguments of its ``unet_tpu`` counterpart.
``run`` drives the reference's stages (``Create_tiles``, ``Train``,
``Predict``) from a JSON file of ``api.Params`` fields, as ``unet_tpu run``
does (``--multi``: the list-broadcast multi-run mode); it is the way to
``resume`` from step checkpoints and to set ``checkpoint_every``, as in
``unet_tpu``, and ``--device`` overrides the config's ``device``.
``tile`` is host code, as in ``unet_tpu``, and writes the same tile tree.
``predict`` predicts a folder of tiles into predicted tiles or, with
``--merge``, one overlap-averaged mosaic (``--device-merge``: accumulated
on the card by the ``blend_count`` kernel).
``serve`` takes a scene of any size: a whole-scene mosaic on the card while
it fits, else a band of rows on the card over the scene in RAM, else (past
the host budget, or with ``--stream``) windowed reads with the finished
rows streamed to the output file.
``predict --spatial N`` and ``serve --spatial N`` shard the tile height
over N ranks with halo exchanges (JAX's ``space`` mesh axis): the command
starts the N ranks itself, one a card (``UNET_TPU_TORCH_BACKEND=gloo``
lets them share a card; ``--device cpu`` runs them on the CPU over gloo),
and rank 0 prints and writes; ``run`` does the same for a config whose
``spatial`` is N. A ``.uta`` artifact with ``--spatial`` is refused, as in
``unet_tpu``.
``export`` freezes a bundle's prediction program with ``torch.export``
into a ``.uta`` serving artifact (weights beside it, int8 with
``--quantize int8``); ``predict`` and ``serve`` take an artifact wherever
they take a bundle, on every tier and with ``--device-merge``.
``UNET_TPU_BN`` (``fused``, ``pallas``, ``slice[:k]``, ``group[:g]``)
selects the BatchNorm variant of every model built, as in ``unet_tpu``.
``train`` (tpu_opt by default; ``--no-tpu-opt`` the parity topology,
``--self-attention`` in either; ``--regression``, ``--lr-finder``,
``--existing-model``, ``--pretrained-weights`` (a ``.pth`` or an ``.npz``
that ``import-weights`` writes), ``--grad-accum``, ``--reference-quirks``,
``--profile-dir`` and, for data parallelism over processes, ``--coordinator
host:port --num-processes N --process-id I`` (all three, the same command
in every process) as in ``unet_tpu``), ``predict`` and ``serve`` (any bundle:
tpu_opt, parity, imported) and ``import-model`` (a fastai DynamicUnet
state_dict → a parity bundle) also take ``--device`` (default ``cuda``);
``train`` and ``serve``
take ``--stats-json`` (write the run's timings, kernel launch counts and,
for ``train``, the loader's decode path, for ``serve`` each scene's tier
to a JSON file); both compute in bf16.
``doctor`` checks whether this machine is ready: versions, the CUDA
device, a one-process data-parallel group (``mesh``), the nvcc
toolchain, the native decoder and, with ``--kernels`` (also spelled
``--pallas``, as in ``unet_tpu``), every CUDA kernel against
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

    run = sub.add_parser("run", help="run stages from a JSON params file")
    run.add_argument("config", help="JSON file with Params fields")
    run.add_argument("--multi", action="store_true", help="list-broadcast multi-run mode")
    run.add_argument("--device", default=None,
                     help="torch device, in place of the config's (default cuda)")

    tile = sub.add_parser("tile", help="split a GeoTIFF into training tiles")
    tile.add_argument("image")
    tile.add_argument("--mask", default=None)
    tile.add_argument("--base-dir", required=True)
    tile.add_argument("--patch-size", type=int, default=400)
    tile.add_argument("--patch-overlap", type=float, default=0.0)
    tile.add_argument("--split", type=float, nargs="+", default=[0.8, 0.2])
    tile.add_argument("--max-empty", type=float, default=0.9)
    tile.add_argument("--class-zero", action="store_true")
    tile.add_argument("--seed", type=int, default=None)
    tile.add_argument("--reference-quirks", action="store_true")
    tile.add_argument("--compress", default=None,
                      choices=["none", "deflate", "lzw", "packbits", "jpeg", "jpeg-lossless"],
                      help="tile output compression (img tiles; masks keep "
                           "exact labels — lossy jpeg maps to deflate for "
                           "them)")

    tr = sub.add_parser("train", help="train a model on a tile dataset")
    tr.add_argument("data_path")
    tr.add_argument("--model-path", required=True)
    tr.add_argument("--description", default="model")
    tr.add_argument("--codes", nargs="+", default=["Background", "Class_1"])
    tr.add_argument("--arch", default="xresnet34")
    tr.add_argument("--batch-size", type=int, default=4)
    tr.add_argument("--epochs", type=int, default=15)
    tr.add_argument("--lr", type=float, default=1e-4)
    tr.add_argument("--regression", action="store_true")
    tr.add_argument("--class-weights", default="even")
    tr.add_argument("--self-attention", action="store_true",
                    help="self-attention in the third-from-last decoder block")
    tr.add_argument("--existing-model", default=None,
                    help="transfer learning: start from this bundle's weights "
                         "and topology")
    tr.add_argument("--lr-finder", default=None,
                    help="minimum|steep|valley|slide: sweep the LR first and "
                         "train at the suggestion")
    tr.add_argument("--pretrained-weights", default=None,
                    help="torch .pth or converted .npz (see import-weights)")
    tr.add_argument("--tpu-opt", action=argparse.BooleanOptionalAction, default=True,
                    help="the tpu_opt topology (default); --no-tpu-opt trains the "
                         "reference-shaped parity topology (also chosen for tiles "
                         "whose sides are not divisible by 4)")
    tr.add_argument("--grad-accum", type=int, default=1,
                    help="split each batch into N sequential microbatches: "
                         "less activation memory a step (BatchNorm uses "
                         "microbatch statistics)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--reference-quirks", action="store_true")
    tr.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the first epoch here")
    tr.add_argument("--coordinator", default=None,
                    help="data parallelism over processes: the coordinator's "
                         "host:port (run the same command in every process)")
    tr.add_argument("--num-processes", type=int, default=None,
                    help="data parallelism: the number of processes")
    tr.add_argument("--process-id", type=int, default=None,
                    help="data parallelism: this process's rank (0-based)")
    tr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    tr.add_argument("--stats-json", default=None,
                    help="write steps, seconds, tiles/s, step ms, kernel "
                         "launch counts, peak card memory and the LR sweep here")

    pr = sub.add_parser("predict", help="predict tiles with a trained bundle")
    pr.add_argument("model")
    pr.add_argument("tiles")
    pr.add_argument("--merge", action="store_true")
    pr.add_argument("--regression", action="store_true")
    pr.add_argument("--all-classes", action="store_true")
    pr.add_argument("--specific-class", type=int, default=None)
    pr.add_argument("--large-file", action="store_true")
    pr.add_argument("--aoi", default=None)
    pr.add_argument("--year", default=None)
    pr.add_argument("--validation-vision", action="store_true")
    pr.add_argument("--class-zero", action="store_true",
                    help="0 = nodata: decrement classes on write "
                         "(reference predict.py:32-35)")
    pr.add_argument("--device-merge", action="store_true",
                    help="accumulate the merge mosaic on the device (the "
                         "blend_count kernel) instead of on the host")
    pr.add_argument("--batch-size", type=int, default=16)
    pr.add_argument("--spatial", type=int, default=1,
                    help="shard tile height over this many ranks, one a card "
                         "(halo exchanges), for tiles too big for one card")
    pr.add_argument("--tta", action="store_true",
                    help="4-fold flip test-time augmentation (averaged "
                         "probabilities; 4x forward cost)")
    pr.add_argument("--reference-quirks", action="store_true")
    pr.add_argument("--compress", default=None,
                    choices=["none", "deflate", "lzw", "packbits", "jpeg", "jpeg-lossless"],
                    help="output compression for prediction tiles / the "
                         "merged mosaic")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")

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
                    help="shard patch height over this many ranks, one a card "
                         "(halo exchanges), for patches too big for one card")
    sv.add_argument("--tta", action="store_true",
                    help="4-fold flip test-time augmentation (averaged "
                         "probabilities; 4x forward cost)")
    sv.add_argument("--compress", default=None,
                    choices=["none", "deflate", "lzw", "packbits", "jpeg", "jpeg-lossless"],
                    help="output mosaic compression")
    sv.add_argument("--stream", action="store_true",
                    help="force the O(band)-memory streamed path (windowed "
                         "reads, strip-streamed output); automatic for "
                         "scenes whose mosaic would exceed host RAM")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    sv.add_argument("--stats-json", default=None,
                    help="write windows, batches, seconds, tiles/s, forward "
                         "ms per batch, each scene's tier and finalize "
                         "seconds, kernel launch counts and peak card memory "
                         "here")

    ex = sub.add_parser(
        "export",
        help="freeze a trained bundle as a serving artifact (.uta): the prediction "
             "program captured with torch.export + raw weights; loads without "
             "model-building code, no pickle, symbolic batch")
    ex.add_argument("model", help="trained bundle (model_path/description)")
    ex.add_argument("output", help="artifact path (convention: .uta)")
    ex.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated devices the artifact may load on "
                         "(default cpu,cuda)")
    ex.add_argument("--patch-size", type=int, default=None,
                    help="override the manifest tile size (spatial dims are "
                         "static per artifact; batch is symbolic)")
    ex.add_argument("--quantize", choices=["int8"], default=None,
                    help="per-channel int8 weight quantization: ~4x smaller "
                         "artifact, dequantized on the device, bf16 compute")
    ex.add_argument("--device", default="cuda",
                    help="torch device the program is exported on (default cuda; "
                         "cpu only when asked)")

    iw = sub.add_parser(
        "import-weights",
        help="convert a torch/fastai xresnet state_dict (.pth) to an .npz for "
             "--pretrained-weights")
    iw.add_argument("state_dict", help="path to the torch .pth file")
    iw.add_argument("--arch", default="xresnet34")
    iw.add_argument("-o", "--out", default=None,
                    help="output .npz (default: <state_dict>.npz)")

    im = sub.add_parser(
        "import-model",
        help="convert a full trained fastai DynamicUnet state_dict (.pth) into "
             "a prediction-ready model bundle (save the .pth on any fastai "
             "machine with torch.save(learn.model.state_dict(), path))")
    im.add_argument("state_dict", help="path to the torch .pth file")
    im.add_argument("bundle", help="output bundle directory (model_path/description)")
    im.add_argument("--description", default=None,
                    help="bundle name (default: bundle dir name)")
    im.add_argument("--patch-size", type=int, default=400,
                    help="tile size the model was trained at (reference default 400)")
    im.add_argument("--regression", action="store_true")
    im.add_argument("--codes", nargs="*", default=None, help="class names, for the manifest")
    im.add_argument("--dtype", default="int8",
                    help="training-data dtype for predict-time scaling "
                         "(int8|uint8|int16|float32; reference rule)")
    im.add_argument("--device", default="cuda",
                    help="torch device the weights are loaded and checked on "
                         "(default cuda; cpu only when asked)")

    dr = sub.add_parser("doctor", help="diagnose the environment: versions, CUDA "
                                       "device, nvcc, native decoder, kernels")
    dr.add_argument("--kernels", "--pallas", dest="kernels", action="store_true",
                    help="also build every CUDA kernel and check it against its "
                         "plain version on the card")
    return ap


def cli(argv=None) -> int:
    return rank_command(build_parser().parse_args(argv))


def rank_command(args) -> int:
    """Run the parsed command; the errors a user can act on exit 2 with
    one line. What each rank of a spatial command runs (``mesh.launch``)."""
    if os.environ.get("UNET_TPU_TRACEBACK"):
        return _dispatch(args)
    try:
        return _dispatch(args)
    except (OSError, ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        print("(set UNET_TPU_TRACEBACK=1 for the full traceback)", file=sys.stderr)
        return 2


ARTIFACT_SPATIAL = ("--spatial needs a live model bundle (the artifact's program is "
                    "frozen without sharding); export is for single-chip serving")


def _launch_spatial(args) -> int:
    """``predict``/``serve --spatial N`` without a process group: refuse a
    ``.uta`` model (JAX's words) and a patch that does not split into N
    ranks' rows, then start the N ranks (``mesh.launch``), each running the
    command: 0 when every rank exits 0, else the first failing rank's code."""
    from .parallel import mesh
    from .predict.artifact import is_artifact

    if is_artifact(args.model):
        raise SystemExit(ARTIFACT_SPATIAL)
    if args.command == "serve":
        from .models.unet import check_spatial_height
        from .train import checkpoint as ckpt

        manifest = ckpt.load_manifest(ckpt.bundle_paths(args.model)[1])
        check_spatial_height(manifest.get("ARCHITECTURE", "xresnet34"),
                             int(args.patch_size or manifest.get("patch_size", 400)),
                             args.spatial)
    return mesh.launch(args.spatial, "unet_tpu_torch.__main__:rank_command", (args,),
                       device=args.device)


def train_kernel_launches() -> dict:
    """Launch count of each CUDA kernel of the train path in this process."""
    from .ops.aug import fused_flip_scale
    from .ops.bn import bn_bwd_sums, bn_sum_sumsq

    return {"bn_sum_sumsq": bn_sum_sumsq.launches,
            "bn_bwd_sums": bn_bwd_sums.launches,
            "flip_scale": fused_flip_scale.launches}


def _peak_device_bytes(device):
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _dispatch(args) -> int:
    if args.command == "run":
        import dataclasses

        from .api import main, main_multi, params_from_json

        p = params_from_json(args.config)
        if args.device is not None:
            p = dataclasses.replace(p, device=args.device)
        (main_multi if args.multi else main)(p)
        return 0
    if args.command == "doctor":
        from .utils.doctor import run_doctor

        results = run_doctor(kernels=args.kernels)
        return 0 if all(ok for ok, _ in results.values()) else 1
    if args.command == "tile":
        from .tiling import split_raster

        n = split_raster(args.image, args.mask, args.base_dir, args.patch_size,
                         args.patch_overlap, args.split, args.max_empty, args.class_zero,
                         seed=args.seed, reference_quirks=args.reference_quirks,
                         compress=_compress_arg(args))
        print(f"{n} tiles written to {args.base_dir}")
        return 0
    if args.command in ("predict", "serve") and args.spatial > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            return _launch_spatial(args)
    if args.command == "predict":
        return _predict(args)
    if args.command == "export":
        from .predict.artifact import export_artifact

        t0 = time.perf_counter()
        out = export_artifact(args.model, args.output,
                              platforms=[p for p in args.platforms.split(",") if p],
                              patch_size=args.patch_size, quantize=args.quantize,
                              device=args.device)
        print(f"Artifact written to {out} ({out.stat().st_size / 1e6:.1f} MB, "
              f"{time.perf_counter() - t0:.1f} s)")
        return 0
    if args.command == "import-weights":
        from .models.torch_import import import_weights_cli

        out = args.out or (str(args.state_dict).rsplit(".", 1)[0] + ".npz")
        import_weights_cli(args.state_dict, out, arch=args.arch)
        return 0
    if args.command == "import-model":
        from .models.torch_import import import_model_cli

        import_model_cli(args.state_dict, args.bundle, description=args.description,
                         patch_size=args.patch_size, regression=args.regression,
                         codes=args.codes, dtype_str=args.dtype, device=args.device)
        return 0
    return _train(args) if args.command == "train" else _serve(args)


DISTRIBUTED_ARGS = (("coordinator", "--coordinator"), ("num_processes", "--num-processes"),
                    ("process_id", "--process-id"))


def _train(args) -> int:
    from .parallel import mesh

    given = [flag for attr, flag in DISTRIBUTED_ARGS if getattr(args, attr) is not None]
    if given and len(given) < len(DISTRIBUTED_ARGS):
        raise ValueError(f"{', '.join(given)} given without "
                         + ", ".join(f for _, f in DISTRIBUTED_ARGS if f not in given)
                         + ": data parallelism needs all three")
    if not given:
        return _train_run(args)
    mesh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                          device=args.device)
    try:
        return _train_run(args)
    finally:
        mesh.close_distributed()


def _train_run(args) -> int:
    from .parallel import mesh
    from .train.loop import Trainer, TrainerConfig, train_model

    cw = args.class_weights
    if cw not in ("even", "weighted"):
        cw = json.loads(cw)
    cfg = TrainerConfig(data_path=args.data_path, model_path=args.model_path,
                        description=args.description, codes=args.codes,
                        arch=args.arch, batch_size=args.batch_size,
                        epochs=args.epochs, lr=args.lr, regression=args.regression,
                        class_weights=cw, self_attention=args.self_attention,
                        existing_model=args.existing_model, lr_finder=args.lr_finder,
                        pretrained_weights=args.pretrained_weights,
                        tpu_opt=args.tpu_opt, seed=args.seed, grad_accum=args.grad_accum,
                        reference_quirks=args.reference_quirks,
                        profile_dir=args.profile_dir, device=args.device)
    trainer = Trainer(cfg)
    if trainer.device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(trainer.device)
    t0 = time.perf_counter()
    out = train_model(cfg, trainer)
    seconds = time.perf_counter() - t0
    if not mesh.is_primary():  # rank 0 reports for the process group
        return 0
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
            "peak_device_bytes": _peak_device_bytes(trainer.device),
            "lr_find": trainer.lr_find_result,
        }
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _compress_arg(args):
    """The argparse surface spells no compression 'none'."""
    return None if args.compress in (None, "none") else args.compress


def _artifact_predictor(args):
    """An ``ArtifactPredictor`` on ``--device`` when the model argument is a
    ``.uta`` serving artifact, for the ``predictor=`` of every predict and
    serve path; None for a bundle. An artifact with ``--spatial`` is
    refused (JAX's words)."""
    from .predict.artifact import is_artifact, load_artifact

    if not is_artifact(args.model):
        return None
    if args.spatial > 1:
        raise SystemExit(ARTIFACT_SPATIAL)
    return load_artifact(args.model, batch_size=args.batch_size, tta=args.tta,
                         device=args.device)


def _predict(args) -> int:
    from .predict.predict import save_predictions

    out = save_predictions(args.model, args.tiles, args.regression, args.merge,
                           args.all_classes, args.specific_class, args.large_file,
                           args.aoi, args.year, args.validation_vision,
                           class_zero=args.class_zero, batch_size=args.batch_size,
                           spatial=args.spatial, tta=args.tta,
                           device_merge=args.device_merge,
                           reference_quirks=args.reference_quirks,
                           predictor=_artifact_predictor(args),
                           out_compress=_compress_arg(args), device=args.device)
    print(f"Predictions at {out}")
    return 0


def _serve(args) -> int:
    import torch

    from .ops.blend import blend_and_count
    from .predict.predict import (Predictor, predict_raster, predict_raster_streamed,
                                  serve_scenes)

    compress = _compress_arg(args)
    predictor = _artifact_predictor(args) or Predictor(
        args.model, batch_size=args.batch_size, device=args.device,
        dtype=torch.bfloat16, tta=args.tta, spatial=args.spatial)
    common = dict(patch_size=args.patch_size, patch_overlap=args.patch_overlap,
                  batch_size=args.batch_size, regression=args.regression,
                  all_classes=args.all_classes,
                  specific_class=args.specific_class,
                  class_zero=args.class_zero, tta=args.tta, spatial=args.spatial,
                  predictor=predictor, out_compress=compress,
                  device=predictor.device, dtype=predictor.dtype)
    t0 = time.perf_counter()
    if len(args.raster) > 1:
        # as in unet_tpu: several scenes go through serve_scenes, each on
        # its own tier, and --stream is not consulted
        outs = serve_scenes(args.model, args.raster, args.output, **common)
        print(f"{len(outs)} mosaics in {args.output}")
    elif args.stream:
        predict_raster_streamed(args.model, args.raster[0], args.output, **common)
        print(f"Mosaic streamed to {args.output}")
    else:
        arr, _, _ = predict_raster(args.model, args.raster[0], args.output, **common)
        if arr is None:
            print(f"Mosaic streamed to {args.output}")
        else:
            print(f"Mosaic {arr.shape} written to {args.output}")
    seconds = time.perf_counter() - t0
    if args.stats_json and predictor.primary:  # rank 0 reports for a spatial group
        scenes = predictor.scenes
        n_windows = sum(s["windows"] for s in scenes)
        stats = {
            "device": str(predictor.device),
            "device_name": _device_name(predictor.device),
            "windows": n_windows,
            "batches": sum(s["batches"] for s in scenes),
            "seconds": seconds,
            "tiles_per_s": n_windows / seconds,
            "forward_ms": predictor.forward_ms(),
            "scenes": scenes,
            "launches": {"blend_count": blend_and_count.launches},
            "peak_device_bytes": _peak_device_bytes(predictor.device),
            "spatial": args.spatial,
        }
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
