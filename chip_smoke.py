"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero), in this order:
  1. the card: nvidia-smi name and power limit, torch and CUDA versions,
     and whether matplotlib and pandas import there;
  2. build every CUDA kernel and the native tile decoder from the repo
     sources (one nvcc for each kernel source and one g++, all started
     together, cold);
  3. blend_count vs its plain version on random tiles: bit-equal, and both
     timed; offset_copy bit-equal to its plain version at every offset of a
     (64, 128) source and at the probe's own (16, 128), offset 1, an
     out-of-range offset refused, and the kernel timed beside its plain
     version, an ``index_select`` and an empty kernel (the launch latency
     that bounds it);
  4. serve: a seeded random-init xresnet34 tpu_opt bundle (3 classes, 512²
     tiles, bf16) serves a 4096×4096×3 GeoTIFF through
     ``python -m unet_tpu_torch serve`` in a subprocess; the class map is
     checked and the run's kernel launch count read back;
  5. blend_count vs its plain version on the served scene's 100 windows,
     bit-equal, and the kernel timed at those shapes beside its bound and a
     library scatter-add; the host phases of a serve timed one by one (the
     host finalize_mosaic of PRs 1-6 beside the finalize on the card, which
     must equal it), and the scene served again in this process with the
     model resident (warm tiles/s, the forwards' share of it, the finalize
     on the card, the kernel's launch count);
     5b. the reference-shaped model, xresnet34 parity topology with
     self-attention (γ = 0.5, as γ = 0 makes the attention an identity),
     same widths, classes, tiles, batch and bf16: a seeded bundle serves
     the scene through ``python -m unet_tpu_torch serve`` (class map
     checked, one blend_count launch a batch), then warm in this process
     (tiles/s, forward ms a batch, launches), and bf16 against float32
     class maps on 16 windows of 512² and of 402² (a side not divisible by
     4: the decoder's nearest-resizes), >= 99% each;
     5c. any-size serve. (a) The 4096² scene through predict_raster's
     three tiers in float32 with TF32 off, in this process: the whole-scene
     mosaic, the band over the scene in RAM (device_budget_bytes=0) and
     predict_raster_streamed; banded == streamed bit for bit, the
     whole-scene map >= 99.99% equal to the banded one and equal wherever
     its top-two margin is >= 1e-5, the finalize on the card == the host
     finalize_mosaic on the same sums in all four modes, and blend_count ==
     its plain version at the band's offsets over the band's batches (most
     wrap from one window row to the next); launches 7 for the whole
     mosaic and one a batch's window row for the band. (b) A 20000² 3-band
     uint8 scene (the 4096² scene tiled; 2401 windows, 151 batches; its
     6.4 GB mosaic exceeds the 4 GiB device budget) with the flagship
     bundle in bf16: ``python -m unet_tpu_torch serve`` (default budgets:
     the band over the scene in RAM) and ``serve --stream`` in
     subprocesses, then both tiers in this process with the model
     resident; the in-process maps bit-equal, each CLI map >= 99.99% equal
     to its twin, valid classes, the scene's georeference, one launch an
     add; each run's tiles/s, seconds, finalize seconds, host read and
     write seconds, launches, peak card memory and peak host RSS;
  6. the training kernels vs their plain versions on random inputs, timed
     beside their bound and a PyTorch library call: bn_stats forward and
     backward at the (C, H·W) shapes of the 43 training BatchNorms of the
     xresnet34 U-Net at batch 16 × 512² in both topologies (tpu_opt's 7,
     parity's 6 with its stem's (32, 256²)), in bf16 and float32, plus two
     ragged shapes (within 1e-6 of the float64 sums, relative to Σ|x|,
     Σx², Σ|dy| and Σ|dy·x̂|; two launches bit-identical), with totals per
     train step of each topology, and flip_scale on
     16 × 3 × 512² uint8 tiles with uint8 masks and mixed flags and on a
     ragged 16 × 3 × 37 × 301 batch (bit-equal), with the host time its
     wrapper takes a call; PixelShuffleICNR (conv + pixel shuffle) timed
     against the JAX package's formulation (one transposed conv) at the
     parity model's five upsamples;
     then ``doctor --kernels``, the path that runs offset_copy: in this
     process with every launch count set to 0 (each of the five kernels
     launched once, all checks ok), then ``python -m unet_tpu_torch doctor
     --kernels`` in a subprocess (exit 0, its report printed);
  7. the native decoder on the training tile set below: bit-equal to the
     Python codec on every tile and on a few tiles rewritten with LZW,
     deflate, PackBits and JPEG (JPEG segments decode natively in both, as
     in the JAX package; the pure-Python JPEG decoder within 2 levels), and
     the decode ms of a 16-tile batch each way; then train through
     ``python -m unet_tpu_torch train`` in a subprocess: the tpu_opt
     xresnet34 U-Net, random init from seed 0, 1 epoch over a seeded
     synthetic 512² tile set (64 train + 16 valid tiles, 3 classes that are
     a function of the image), batch 16, bf16; the history must be finite
     and every train-step kernel launched as many times as the steps say;
     then the exported bundle serves the 4096² scene of phase 4 in this
     process; the loader's decode path and first-batch times come back in
     the stats file;
  8. train in this process: step milliseconds and tiles/s, the per-step
     launch counts (43 / 43 / 1), and one step with the kernels against one
     with their plain versions from the same state, batch and flags (loss
     within 1e-3 relative, each parameter's gradient within 5e-2 relative
     L2 — bf16 convolutions — relative to at least 1e-2 of the RMS of all
     gradients);
     8b. the parity + self-attention model: ``python -m unet_tpu_torch
     train --no-tpu-opt --self-attention`` for 1 epoch (4 steps and a
     validation batch; launches 43 a step for each bn_stats kernel, one
     flip_scale a batch; the exported u vectors moved from their init) and
     its bundle served in this process; then in this process the step
     time, the per-step launches and a kernel step against a plain step
     (the bars of 8), and the self-attention and the full-resolution tail
     timed alone;
     8c. the training surface on the flagship at 16 × 512², bf16: (a) every
     augmentation op at p = 0.5 on a uint8 batch and on an int16 one under
     reference_quirks with n_transform_imgs 0.5, the kernel path bit-equal
     to the same draws through the plain flip_scale, one launch a batch,
     µs a batch and the plain passes' share; (b) grad_accum 1, 2 and 4
     with that augmentation: 43 × grad_accum launches of each bn_stats
     kernel a step and one flip_scale, a kernel step against a plain step
     (the bars of 8), step ms and peak card memory; (d) fit with the LR
     finder (a short sweep) starts from the seed's weights bit for bit;
     (e) a fastai-named xresnet34 .pth (seed 7) through the CLI's
     ``import-weights`` (in process) to an .npz, each grafted in both
     topologies bit-equal to the source (tpu_opt's folded stem keeps its
     init), a step each; (f) ``existing_model`` on phase 4's bundle from a
     parity config adopts tpu_opt and starts from its weights bit for
     bit; (g) dice (bf16 printed; float32 held), MSE, L1 and smooth L1
     kernel steps against plain steps in float32 with TF32 off, on a
     continuous target (the tiles' band mean over 15 × 15 ÷ 255); (c) and
     (d) ``python -m unet_tpu_torch train --regression --lr-finder
     valley`` for 1 epoch on that target (the sweep's steps launch the
     kernels too; rmse and r2_score finite; the LR CSV written) and its
     bundle served over the 4096² scene (7 blend_count launches, float32,
     no nodata, the finalize on the card bit-equal to the host's); the
     phase's seconds;
  9. bf16 vs float32 class maps on one batch of 16 tiles (>= 99% agree);
     9b. the reference pipeline at full width: the scene's labels written
     as a mask GeoTIFF; ``python -m unet_tpu_torch tile`` cuts the scene
     and mask into 512² tiles (overlap 0.2, split 0.8 / 0.2, seed 0; the
     trai / vali layout and every tile on the scene's grid checked) and,
     side by side, the prediction tiles (no mask, max_empty 1.0); the
     flagship trains 1 epoch on them with the weighted focal loss (launch
     counts set to 0 before and read after), and a focal kernel step is
     held against a plain step (the bars of 8); ``python -m unet_tpu_torch
     predict --merge`` runs on the host and with ``--device-merge``: both
     mosaics uint8 4096², georeferenced like the scene, >= 99.99% equal
     (bit-equal as a rule), the device merge >= 99.99% equal to serve in
     float32 (TF32 off; bf16 printed); in this process each mode's tiles/s,
     merge finalize seconds and blend_count launches (7 on the device
     merge, 0 on the host's); then ``save_predictions(...,
     validation_vision=True)`` with the model resident on the validation
     tiles, their masks beside them: the printed tile-majority confusion
     matrix sums to the tiles with masks, its diagonal share and the report
     printed, the two figures drawn or skipped with a line naming the
     missing plotting modules;
     9c. the quality gate of tests/test_quality_parity.py on the card, field
     for field (the fixture's 384² scene, 128² tiles, xresnet18, weighted
     focal, float32, ``save_predictions(merge=True)``): parity at 14
     epochs and tpu_opt at 20 on seeds 0 and 1 held to the JAX floors,
     seed 2 measured against them, then tpu_opt seed 0 in bf16, printed;
     9d. the reference's own entry point, resume and data parallelism at
     full width (xresnet34 tpu_opt, 3 classes, 512² tiles, bf16, batch 16,
     the 4096² scene and its labels): (a) ``python -m unet_tpu_torch run``
     of a JSON ``Params`` file with Create_tiles, Train (2 epochs, a
     checkpoint each, the model summary) and Predict (9b's prediction tiles
     merged on the host), ``visualize_data_example`` and
     ``validation_vision`` left at the reference's defaults (True), in a
     subprocess: its tile tree byte-equal to 9b's and its mosaic checked,
     the batch's printed shape and value range, the two histograms and the
     loss plot drawn or skipped with a line each (matplotlib); then the
     same ``Params`` through ``api.main`` in this process with every launch
     count at 0 (43 × steps for each bn_stats kernel, one flip_scale a step
     and a validation batch, no blend_count); (b) a 3-epoch ``run`` killed
     (SIGKILL) once ``checkpoints/1`` is complete, then resumed (``resume``): its
     history holds epochs 1-2 and its bundle serves the scene; a
     saved-then-restored state bit-equal; (c) two ranks on the one card
     over gloo, 8 tiles each of a batch of 16: (43, 43, 1) launches a rank
     and step, the float32 2-rank step (TF32 off) held against the same
     synchronized step through the plain versions and against one
     process's step on the same 16 tiles (the bars of 8), the bf16 one
     printed, the ranks' weights bit-equal after 3 steps and each rank's
     step ms printed (two ranks sharing one card: not a scaling figure);
     two ranks on one card under NCCL refused, naming gloo; ``train
     --coordinator --num-processes 2 --process-id i`` with
     ``UNET_TPU_TORCH_BACKEND=gloo`` for 1 epoch, one bundle, rank 0's
     launches; (d) ``doctor``'s mesh check (NCCL, world 1); offset_copy's
     launches over the phase counted; the phase's seconds;
  11. serving artifacts and model variants: (a) ``python -m unet_tpu_torch
     export`` of 9b's focal-trained flagship bundle to a float artifact
     (``--platforms cpu,cuda``) and an int8 one (``--quantize int8``),
     side by side: seconds, artifact, program and weight bytes, the int8
     artifact < 0.35 of the float one and the program < 10% of the
     weights; (b) the 4096² scene through the float artifact: ``serve``
     through the CLI on the whole tier (tier and blend_count launches
     checked, tiles/s beside phase 4's CLI serve), the artifact's and the
     bundle's load and first batch timed in this process, then both warm
     on the whole tier, streamed and with TTA (tiles/s, launches; bf16
     maps >= 99.99% equal through the same batches); an
     artifact exported in this process at float32 against a float32
     ``Predictor`` with TF32 off (all-class mosaic within 1e-5, class maps
     all equal); the int8 artifact's class agreement with the bundle >
     0.97; when the float artifact's median warm forward exceeds 1.5× the
     bundle's, one forward of each is traced at the end of phase 10, with
     the other traces (wall against the card's busy time, the host's top
     ops); (c) ``predict --merge --device-merge`` with the artifact on 9b's
     prediction tiles, >= 99.99% equal to the bundle's device merge, and in
     this process at float32 (TF32 off) with one launch a batch; (d) a
     flagship trainer at 16 × 512² bf16 for ``UNET_TPU_BN`` unset,
     ``slice:8`` and ``group:32``: step ms, launches a step (43 / 43 / 1;
     group 0 / 0 / 1), a kernel step against a plain step (the bars of 8);
     the group trainer's bundle (its manifest records ``group:32``) and a
     float32 artifact of it served with the variable unset (float32, TF32
     off): class maps equal to the training build's in eval, the plain
     BatchNorm build's agreement printed beside;
     the slice variant's float32 running statistics equal to those of the
     first 8 samples of each site's input; (e) remat: a float32 step (TF32
     off) with and without it from the same weights and batch, loss,
     gradients and running statistics compared (bit-equal expected; the
     statistics must be), bn_sum_sumsq launched 43 + 39 recomputed sites,
     peak card memory of both, then bf16 step ms and peak memory of both;
  12. spatial partitioning (the tile height sharded over ranks with halo
     exchanges), ranks sharing the one card over gloo: (a) ``python -m
     unet_tpu_torch serve --spatial 2`` with ``UNET_TPU_TORCH_BACKEND=gloo``
     (the command starts its two ranks) on the 4096² scene: the bf16 map
     >= 99% equal to phase 4's unsharded CLI map (JAX's bar), rank 0's
     blend_count launches equal to phase 4's; in process, two spawned
     ranks serve the scene at float32 (TF32 off): every class's
     probabilities within 1e-5 of rank 0's unsharded serve and the classes
     equal wherever the unsharded top-two margin is >= 2e-5 (closer ties
     may flip within that bar: cuDNN picks its float32 algorithms by the
     rows a rank holds), blend_count on rank 0 as often as unsharded and
     never on rank 1; (b) the flagship's float32 spatial step at 16 × 512² (TF32 off)
     against 9d's one-process step on the same tiles and draws (the bars
     of 8), (43, 43, 1) launches a rank and step, each rank's kernel step
     against a plain step, the ranks' weights bit-equal after 3 bf16
     steps, each rank's step ms (not a scaling figure); (c) each rank's
     peak card memory over a bf16 forward of one 4096² window at spatial
     1, 2 and 4 (four more spawned ranks); offset_copy's count read in
     every spawned rank (0: not on this path). The CLI and then the
     two-rank spawn run alone on the card; the four ranks at spatial 4,
     which read peak memory only, run beside 9c's quality gate (which
     times nothing);
  13. ``python -m unet_tpu_torch bench --tile 256 --batch-size 4 --steps
     4`` through the CLI, each section in a child process of its own (aim:
     150 s): exit 0, the headline JSON first and last on stdout, the seven
     section lines and the detail on stderr with no error, 43 / 43 / 1
     launches a step in both train sections, the float artifact's maps
     equal to the bundle's, blend_count in the streamed scene, the five
     kernels in its kernels section; each kernel's figures there go into
     the kernels' JSON line under ``bench``;
  10. last, as the profiler slows later launches: the device time of every
     kernel, its plain version and its library call at the shapes above
     (the union of the traced device intervals, host overhead left out;
     the CUDA-event times per call include it); from the same traces, one
     call of flip_scale (main and ragged shapes) and of offset_copy must be
     exactly one device operation, their kernel — flip_scale's main shape
     on the word path, the ragged one on the element path — and each
     kernel's own interval is printed beside the union, flip_scale's with
     its GB/s against the bytes bound; then a warm serve and a few train
     steps of each topology under torch.profiler for the card's idle share,
     with the parity step's device time by kernel and by PyTorch op (the
     attention products and softmax named), and of a device-merge predict;
     bn_sum_sumsq and bn_bwd_sums alone at the parity stem's (16, 32, 256²)
     site by device time, beside their bounds; blend_count's kernel time
     at the 20000² band for a batch within a window row and for a batch
     that wraps rows, whole and split a window row a launch; and the
     card's idle share of a warm streamed 20000² serve (device activity
     only).
The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Needs no network; work files go to a
temporary directory inside the checkout and are removed at the end.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from unet_tpu_torch.utils.timing import (BN_SITES, HBM_BYTES_PER_S, blend_bound_ms, bn_work,
                                         bound, cuda_ms, device_busy_s, device_trace,
                                         flip_work, library_index_add_fn, offset_copy_work)

ROOT = Path(__file__).resolve().parent
SEED = 0
SCENE = 4096
PATCH = 512
BATCH = 16
N_OUT = 3
# BN_SITES (utils/timing.py): (C, H = W, count) of the 43 training
# BatchNorms of the xresnet34 tpu_opt U-Net at 512² tiles, at batch 16;
# the same for the parity topology (three-conv stem at 32/32/64 channels)
BN_SITES_PARITY = [(32, 256, 2), (64, 256, 2), (64, 128, 7), (128, 64, 10),
                   (256, 32, 14), (512, 16, 8)]
BN_RAGGED = [(3, 3, 37, 41), (5, 1, 17, 13)]  # (N, C, H, W): C = 3 and 1, odd N·H·W
PARITY_STEM_SITE = (32, 256)  # (C, H = W): read alone for its device time
TRAIN_EPOCHS = 1      # CLI training: 1 epoch of 64 // 16 = 4 steps
TRAIN_STEPS = 4       # in-process timed steps
PROFILED_STEPS = 3
GRAD_REL_L2 = 5e-2    # kernel vs plain step, per parameter tensor (bf16 convs)
GRAD_FLOOR = 1e-2     # ... relative to at least this share of the gradients' RMS
LATE_UNIT = {"blend_count": "batch of 16 tiles", "bn_sum_sumsq": "train step",
             "bn_bwd_sums": "train step", "flip_scale": "train batch",
             "offset_copy": "call"}
FLIP_RAGGED = (BATCH, 3, 37, 301)  # W % 4 != 0: flip_scale's element path
FLIP_GROUP = re.compile(r"flip_scale_kernel<[^<>]*, (\d)>")
REDESIGNED = ("flip_scale", "offset_copy")  # redesigned after their first port (PERF.md §6)
# the reference-shaped model: fastai DynamicUnet (parity topology, blur,
# blur_final, last_cross) with self-attention, at the flagship's widths
PARITY = dict(arch="xresnet34", n_out=N_OUT, c_in=3, self_attention=True, tpu_opt=False)
SA_GAMMA = 0.5        # γ = 0 (its init) would make the attention an identity
PARITY_ODD = 402      # a window side not divisible by 4: the resize path
PARITY_EPOCHS = 1     # CLI training: 1 epoch of 64 // 16 = 4 steps
PARITY_STEPS = 4      # in-process timed parity steps
PIPE_EPOCHS = 1       # the pipeline's focal training: 1 epoch of the tiled scene
PIPE_STEPS = 3        # in-process focal steps before its kernel-vs-plain step
AGREE = 0.9999        # the pipeline's mosaics: host merge, device merge, serve
BIG = 20000           # any-size serve: a 4 km x 4 km sheet at 20 cm, 49 x 49 windows
# phase 8c, the training surface: every augmentation op at p = 0.5 beside the flips
SURFACE_AUG = dict(rot90_p=0.5, brightness_contrast_p=0.5, saturation_p=0.5,
                   coarse_dropout_p=0.5)
GRAD_ACCUMS = (1, 2, 4)
SURFACE_STEPS = 3     # timed steps at each grad_accum
SWEEP_CHECK_ITERS = 12  # the in-process sweep before the fresh-weights check
PRETRAINED_SEED = 7   # the torch xresnet34 whose .pth is grafted
# the quality gate of tests/test_quality_parity.py, field for field
GATE_SIZE, GATE_TILE = 384, 128
GATE_TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
GATE_CODES = ["nodata", "ground", "trees", "buildings", "water"]
GATE_FLOORS = {"parity": (0.93, 0.93), "tpu_opt": (0.90, 0.93)}  # dice, mIoU
# (topology, seed, epochs, bf16, floors held). tpu_opt seed 2 is measured
# against the floors but not held: its best validation dice swings with the
# float summation order (a few false-positive pixels of a class absent from
# the 4 validation tiles cost a fifth of dice_multi), in the JAX package too
# (PERF.md §6). bf16 has no floor.
GATE_RUNS = [("parity", 0, 14, False, True), ("tpu_opt", 0, 20, False, True),
             ("tpu_opt", 1, 20, False, True), ("tpu_opt", 2, 20, False, False),
             ("tpu_opt", 0, 20, True, False)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_ms(fn, reps: int = 50) -> float:
    """Median milliseconds that one ``fn()`` holds the host, from the call
    to its return (time.perf_counter), the card idle before each call;
    after one warm run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def scene_arrays(size: int, seed: int) -> tuple:
    """(image (3, size, size) uint8, labels (size, size) uint8) of a scene
    with spatial structure: 16 × 16 field-like blocks, smooth waves, a road
    grid and a little noise. Labels are a function of the image: 1 on the
    roads, 2 on the bright fields (block band 0 above 130), else 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    blocks = rng.uniform(40, 220, size=(3, 16, 16)).astype(np.float32)
    cell = np.ones((size // 16, size // 16), np.float32)
    road = (yy % 700 < 24) | (xx % 900 < 24)
    bands = []
    for c in range(3):
        wave = 30 * np.sin(yy / (97.0 + 13 * c)) * np.cos(xx / (131.0 - 11 * c))
        bands.append(np.kron(blocks[c], cell) + wave + road * (90.0 - 30 * c)
                     + rng.normal(0, 6, (size, size)))
    img = np.clip(np.stack(bands), 0, 255).astype(np.uint8)
    labels = np.where(road, 1, np.where(np.kron(blocks[0], cell) > 130, 2, 0))
    return img, labels.astype(np.uint8)


def make_scene(path: Path) -> tuple:
    """The 4096² 3-band uint8 scene (seed 0) as a GeoTIFF."""
    from unet_tpu_torch.geo import write_raster

    img, _ = scene_arrays(SCENE, SEED)
    transform = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
    write_raster(path, img, transform=transform, crs="EPSG:25832")
    return transform, "EPSG:25832"


def make_tiles(root: Path) -> Path:
    """The training set: the 4096² scene (seed 0) cut into 64 `trai` tiles
    and a 2048² scene (seed 1) into 16 `vali` tiles, 512² each, with their
    label tiles (the layout `unet_tpu tile` writes)."""
    from unet_tpu_torch.geo import write_raster

    for split, size, seed in (("trai", SCENE, SEED), ("vali", SCENE // 2, SEED + 1)):
        img, labels = scene_arrays(size, seed)
        for sub in ("img_tiles", "mask_tiles"):
            (root / split / sub).mkdir(parents=True)
        for r in range(0, size, PATCH):
            for c in range(0, size, PATCH):
                t = (500000.0 + 0.2 * c, 0.2, 0.0, 5400000.0 - 0.2 * r, 0.0, -0.2)
                name = f"{split}_{r}_{c}.tif"
                write_raster(root / split / "img_tiles" / name,
                             img[:, r:r + PATCH, c:c + PATCH], transform=t,
                             crs="EPSG:25832")
                write_raster(root / split / "mask_tiles" / name,
                             labels[None, r:r + PATCH, c:c + PATCH], transform=t,
                             crs="EPSG:25832")
    return root


def check_class_map(path: Path, transform, crs) -> list:
    """A served class map is uint8 4096², classes < N_OUT, georeferenced
    like the scene; returns the class histogram."""
    from unet_tpu_torch.geo import read_raster

    out = read_raster(path)
    if out.data.dtype != np.uint8 or out.data.shape != (1, SCENE, SCENE):
        raise AssertionError(f"class map {out.data.dtype} {out.data.shape}")
    if int(out.data.max()) >= N_OUT:
        raise AssertionError(f"class {int(out.data.max())} >= {N_OUT}")
    if tuple(out.transform) != transform or out.crs != crs:
        raise AssertionError(f"georeference {out.transform} {out.crs}")
    return np.bincount(out.data.ravel(), minlength=N_OUT).tolist()


def make_bundle(root: Path, name: str = "smoke", parity: bool = False) -> Path:
    """A seeded random-init bundle: the flagship xresnet34 tpu_opt U-Net,
    or with ``parity`` the reference-shaped parity U-Net with
    self-attention (γ set to SA_GAMMA)."""
    from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
    from unet_tpu_torch.models.layers import SelfAttention
    from unet_tpu_torch.train.checkpoint import export_bundle, to_flax_variables

    kw = PARITY if parity else dict(arch="xresnet34", n_out=N_OUT, c_in=3)
    model = init_weights(build_unet(dtype=torch.bfloat16, **kw),
                         torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SelfAttention):
                m.gamma.fill_(SA_GAMMA)
    manifest = {
        "ARCHITECTURE": "xresnet34", "n_out": N_OUT, "c_in": 3,
        "number_of_bands": 3, "patch_size": PATCH, "enable_regression": False,
        "CODES": ["background", "building", "vegetation"],
        "dtype_str": "uint8", "normalize": "unit", "self_attention": parity,
        "tpu_opt": not parity,
        "tpu_opt_topology": None if parity else TPU_OPT_TOPOLOGY_VERSION,
    }
    export_bundle(root / name, name, to_flax_variables(model.state_dict()), manifest)
    return root / name


def vm_rss_bytes(pid: int) -> int:
    """The resident set of process ``pid`` now (``VmRSS``); 0 once it has
    gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


@contextlib.contextmanager
def rss_peak(pid: int, out: dict, every_s: float = 0.02):
    """``out["gb"]``: the largest resident set (``VmRSS`` of
    ``/proc/<pid>/status``) of process ``pid`` sampled every ``every_s``
    while the block runs. (``getrusage``'s ``ru_maxrss`` and ``VmHWM``
    carry a parent's peak into a child on the card's machine, and the
    machine refuses ``clear_refs``, so the peak of one run is sampled.)"""
    stop, peak = threading.Event(), [0]

    def poll():
        while not stop.is_set():
            peak[0] = max(peak[0], vm_rss_bytes(pid))
            stop.wait(every_s)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["gb"] = peak[0] / 1e9


def serve_cli(bundle: Path, scene: Path, out: Path, stats_path=None, extra=()) -> dict:
    """``python -m unet_tpu_torch serve`` of ``scene`` in a subprocess
    (its launch counts start at 0 there), with ``extra`` arguments; the
    stats file's content when ``stats_path`` is given, with the process's
    sampled peak resident set as ``peak_rss_gb``."""
    cmd = [sys.executable, "-m", "unet_tpu_torch", "serve", str(bundle), str(scene),
           str(out), "--patch-size", str(PATCH), "--batch-size", str(BATCH), *extra]
    if stats_path is not None:
        cmd += ["--stats-json", str(stats_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
    with rss_peak(proc.pid, {}) as rss:
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    log(stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"serve of {bundle.name} exited {proc.returncode}")
    if stats_path is None:
        return {}
    return {**json.loads(Path(stats_path).read_text()), "peak_rss_gb": rss["gb"]}


def serve_inprocess(bundle: Path, scene: Path, out: Path) -> None:
    """Serve ``scene`` with ``bundle`` in this process (``predict_raster``
    with a fresh bf16 predictor), the class map written to ``out``."""
    from unet_tpu_torch.predict.predict import Predictor, predict_raster

    pred = Predictor(str(bundle), batch_size=BATCH, device="cuda")
    predict_raster(str(bundle), str(scene), str(out), patch_size=PATCH, batch_size=BATCH,
                   predictor=pred, device=pred.device)


def top_kernels(prof, n: int = 15) -> list:
    """(name, device ms, count) of the ``n`` device activities of a
    ``torch.profiler`` trace with the largest summed time."""
    tot: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = tot.get(e.name, (0.0, 0))
            tot[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, k + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()), key=lambda t: -t[1])[:n]


def device_times(late: list) -> dict:
    """kernel -> {"ms", "plain_ms", "library_ms"}: device time of each timed
    case times its count per main-path unit (a train step, a batch), summed
    over the kernel's cases; a case with a ``parity_count`` also adds to
    ``"parity_ms"`` (per parity train step). A case with a ``symbol`` keeps
    the trace of its kernel calls in ``case["trace"]`` for
    ``one_op_checks``."""
    out: dict = {}
    for case in late:
        tot = out.setdefault(case["kernel"], {"ms": 0.0, "plain_ms": 0.0, "library_ms": None})
        for key, fn in case["fns"].items():
            tr = device_trace(fn, f"{case['kernel']} {key} {case.get('what', '')}", reps=10)
            tot[key] = (tot[key] or 0.0) + case["count"] * tr["ms"]
            if key == "ms" and "parity_count" in case:
                tot["parity_ms"] = tot.get("parity_ms", 0.0) + case["parity_count"] * tr["ms"]
            if key == "ms" and "symbol" in case:
                case["trace"] = tr
    for name, tot in out.items():
        lib = "not measured" if tot["library_ms"] is None else f"{tot['library_ms']:.4f}"
        parity = f", kernel {tot['parity_ms']:.4f} ms per parity step" if "parity_ms" in tot else ""
        print(f"{name} device time (torch.profiler) per {LATE_UNIT[name]}: kernel "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library {lib} ms{parity}")
    return out


def one_op_checks(late: list) -> dict:
    """Each late case with a ``symbol`` (traced by ``device_times``): one
    call must be exactly one device operation, the kernel named
    ``symbol`` — no copy of flags, scales or status — and, where the case
    names a flip_scale ``group``, that path (4 the word path, 1 the element
    path). Prints the kernel's own device interval beside the union and,
    where the case gives its ``bytes``, the achieved rate against the bytes
    bound. Returns {case: (kernel ms, union ms, device operations a call)}."""
    out = {}
    for case in late:
        if "symbol" not in case:
            continue
        tr, what = case["trace"], case["what"]
        names = list(tr["by_name"])
        if tr["ops"] != 1 or len(names) != 1 or case["symbol"] not in names[0]:
            raise AssertionError(f"{what}: {tr['ops']} device operations per call "
                                 f"({names}), expected one, the {case['symbol']} kernel")
        kernel_ms = tr["by_name"][names[0]]
        line = (f"{what}: 1 device operation per call; kernel alone {kernel_ms * 1e3:.2f} us, "
                f"union {tr['ms'] * 1e3:.2f} us (torch.profiler)")
        if "group" in case:
            m = FLIP_GROUP.search(names[0])
            if not m or int(m.group(1)) != case["group"]:
                raise AssertionError(f"{what} ran {names[0]}, expected group {case['group']}")
            line += f"; {'word' if case['group'] == 4 else 'element'} path ({m.group(0)})"
        if "bytes" in case:
            rate = case["bytes"] / (kernel_ms / 1e3)
            line += (f"; {rate / 1e9:.0f} GB/s, {100 * rate / HBM_BYTES_PER_S:.1f}% of "
                     f"the bytes bound's {HBM_BYTES_PER_S / 1e9:.0f} GB/s")
        print(line)
        out[what] = (kernel_ms, tr["ms"], tr["ops"])
    return out


def bn_phase(dev, late: list) -> dict:
    """bn_stats forward and backward against their plain versions and the
    float64 sums at every training BatchNorm shape of both topologies
    (tpu_opt's 7 and parity's 6, one of them new: the parity stem's (32,
    256²)), bf16 and float32, plus ragged shapes; each call timed with
    CUDA events (bf16 sites weighted by their count give the per-step
    totals of each topology), and the bf16 sites queued in ``late`` for
    their device time."""
    from unet_tpu_torch.ops import bn

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    dims = (0, 2, 3)
    keys = ("fwd_ms", "fwd_plain_ms", "fwd_lib_ms", "bwd_ms", "bwd_plain_ms", "bwd_lib_ms",
            "fwd_bound_ms", "bwd_bound_ms")
    step = {k: 0.0 for k in keys}
    pstep = {k: 0.0 for k in keys}
    worst = {"fwd": 0.0, "bwd": 0.0}
    counts: dict = {}
    for i, sites in enumerate((BN_SITES, BN_SITES_PARITY)):
        for c, hw, count in sites:
            counts.setdefault((c, hw), [0, 0])[i] = count
    cases = [((BATCH, c, hw, hw), dt, tc, pc) for (c, hw), (tc, pc) in counts.items()
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(shape, dt, 0, 0) for shape in BN_RAGGED
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dt, count, pcount in cases:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dt)
        dy = torch.randn(shape, generator=g, device=dev).to(dt)
        n_el = x.numel()
        s1, s2 = bn.bn_sum_sumsq(x), bn.bn_sum_sumsq(x)
        sp = bn.bn_sum_sumsq_reference(x)
        c = shape[1]
        mean = s1[0] / (n_el // c)
        inv = torch.rsqrt(torch.clamp(s1[1] / (n_el // c) - mean * mean, min=0) + 1e-5)
        b1, b2 = bn.bn_bwd_sums(dy, x, mean, inv), bn.bn_bwd_sums(dy, x, mean, inv)
        bp = bn.bn_bwd_sums_reference(dy, x, mean, inv)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(b1, b2)):
            raise AssertionError(f"bn_stats not bit-stable across launches at {shape} {dt}")
        x64, dy64 = x.double(), dy.double()
        xhat = (x64 - mean.double().view(1, -1, 1, 1)) * inv.double().view(1, -1, 1, 1)
        checks = ((s1[0], x64.sum(dims), x64.abs().sum(dims), "Σx"),
                  (s1[1], (x64 * x64).sum(dims), (x64 * x64).sum(dims), "Σx²"),
                  (b1[0], dy64.sum(dims), dy64.abs().sum(dims), "Σdy"),
                  (b1[1], (dy64 * xhat).sum(dims), (dy64 * xhat).abs().sum(dims), "Σdy·x̂"))
        for got, want, scale, what in checks:
            err = (got.double() - want).abs()
            if bool((err > 1e-6 * scale).any()):
                raise AssertionError(f"bn_stats {what} at {shape} {dt}: error "
                                     f"{float((err / scale).max()):.3g} of the bound's scale")
        worst["fwd"] = max(worst["fwd"], float((s1 - sp).abs().max()))
        worst["bwd"] = max(worst["bwd"], float((b1 - bp).abs().max()))
        if dt != torch.bfloat16 or not (count or pcount):
            continue
        w = torch.ones(c, device=dev)
        fwd = {"ms": lambda x=x: bn.bn_sum_sumsq(x),
               "plain_ms": lambda x=x: bn.bn_sum_sumsq_reference(x),
               "library_ms": lambda x=x: torch.ops.aten.batch_norm_stats(x, 1e-5)}
        bwd = {"ms": lambda a=(dy, x, mean, inv): bn.bn_bwd_sums(*a),
               "plain_ms": lambda a=(dy, x, mean, inv): bn.bn_bwd_sums_reference(*a),
               "library_ms": lambda a=(dy, x, mean, inv, w): (
                   torch.ops.aten.batch_norm_backward_reduce(*a, True, True, True))}
        late += [{"kernel": "bn_sum_sumsq", "count": count, "parity_count": pcount, "fns": fwd},
                 {"kernel": "bn_bwd_sums", "count": count, "parity_count": pcount, "fns": bwd}]
        if (c, shape[2]) == PARITY_STEM_SITE:
            stem = {"shape": list(shape), "fwd": fwd["ms"], "bwd": bwd["ms"]}
        t = {"fwd_ms": cuda_ms(fwd["ms"]), "fwd_plain_ms": cuda_ms(fwd["plain_ms"]),
             "fwd_lib_ms": cuda_ms(fwd["library_ms"]), "bwd_ms": cuda_ms(bwd["ms"]),
             "bwd_plain_ms": cuda_ms(bwd["plain_ms"]), "bwd_lib_ms": cuda_ms(bwd["library_ms"]),
             "fwd_bound_ms": bound(*bn_work(shape, x.element_size(), False))[0],
             "bwd_bound_ms": bound(*bn_work(shape, x.element_size(), True))[0]}
        for k, v in t.items():
            step[k] += count * v
            pstep[k] += pcount * v
        if (c, shape[2]) == PARITY_STEM_SITE:
            stem.update(t)
        print(f"bn_stats {shape} bf16 x{count} tpu_opt, x{pcount} parity: fwd "
              f"{t['fwd_ms'] * 1e3:.1f} us (plain {t['fwd_plain_ms'] * 1e3:.1f}, "
              f"batch_norm_stats {t['fwd_lib_ms'] * 1e3:.1f}, bound "
              f"{t['fwd_bound_ms'] * 1e3:.1f}); bwd {t['bwd_ms'] * 1e3:.1f} us (plain "
              f"{t['bwd_plain_ms'] * 1e3:.1f}, batch_norm_backward_reduce "
              f"{t['bwd_lib_ms'] * 1e3:.1f}, bound {t['bwd_bound_ms'] * 1e3:.1f})")
    for what, tot in (("tpu_opt", step), ("parity", pstep)):
        print(f"bn_stats: per {what} train step (43 sites, bf16, CUDA events per call): fwd "
              f"{tot['fwd_ms']:.3f} ms, plain {tot['fwd_plain_ms']:.3f}, library "
              f"{tot['fwd_lib_ms']:.3f}, bound {tot['fwd_bound_ms']:.3f}; bwd "
              f"{tot['bwd_ms']:.3f} ms, plain {tot['bwd_plain_ms']:.3f}, library "
              f"{tot['bwd_lib_ms']:.3f}, bound {tot['bwd_bound_ms']:.3f}")
    print(f"bn_stats: {len(cases)} cases within 1e-6 of float64 and bit-stable")
    return {**step, "parity_step": pstep, "fwd_err": worst["fwd"], "bwd_err": worst["bwd"],
            "stem": stem}


def stem_site_device(stem: dict) -> dict:
    """Device time (torch.profiler, ``device_trace``) of one bn_sum_sumsq
    and one bn_bwd_sums call alone at the parity stem's site, beside their
    bytes bounds; a kernel under half of its bound's speed is named."""
    out = {}
    for key, name in (("fwd", "bn_sum_sumsq"), ("bwd", "bn_bwd_sums")):
        ms = device_trace(stem[key], f"{name} {stem['shape']} bf16")["ms"]
        bound = stem[f"{key}_bound_ms"]
        out[name] = {"shape": stem["shape"], "device_ms": ms, "bound_ms": bound,
                     "call_ms": stem[f"{key}_ms"], "share_of_bound_speed": bound / ms}
        print(f"{name} at the parity stem's site {tuple(stem['shape'])} bf16, alone: device "
              f"{ms * 1e3:.1f} us (torch.profiler), call {stem[f'{key}_ms'] * 1e3:.1f} us "
              f"(CUDA events), bound {bound * 1e3:.1f} us (bytes): {100 * bound / ms:.0f}% of "
              f"the bound's speed" + (" -- under half of it" if bound / ms < 0.5 else ""))
    return out


def flip_inputs(dev, shape: tuple, seed: int) -> tuple:
    """(uint8 images ``shape``, uint8 masks, hflip, vflip, scales) of a
    flip_scale call as the trainer makes it: flags and scales on the
    host, mixed flags, the int8 "unit" scale."""
    b, _, h, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    msk = torch.randint(0, N_OUT, (b, h, w), generator=g, device=dev, dtype=torch.uint8)
    return img, msk, torch.arange(b) % 2 == 1, torch.arange(b) % 4 >= 2, torch.full((b,), 1 / 255)


def flip_phase(dev, late: list) -> dict:
    """flip_scale bit-equal to its plain version on a 16 × 3 × 512² uint8
    batch with uint8 masks and mixed flags, and on a ragged 16 × 3 × 37 ×
    301 one; timed beside its bound, and queued in ``late`` for its device
    time and for ``one_op_checks`` (one device operation a call; the main
    shape on the word path, the ragged one on the element path; the
    kernel's own interval and its GB/s) — traced last, as the profiler
    slows later launches."""
    from unet_tpu_torch.ops.aug import fused_flip_scale, fused_flip_scale_reference

    shapes = {"main": (BATCH, 3, PATCH, PATCH), "ragged": FLIP_RAGGED}
    args = {k: flip_inputs(dev, s, SEED + 4 + i) for i, (k, s) in enumerate(shapes.items())}
    err = 0.0
    for k, a in args.items():
        ki, km = fused_flip_scale(*a)
        pi, pm = fused_flip_scale_reference(*a)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(km, pm)):
            raise AssertionError(f"flip_scale differs from its plain version at "
                                 f"{shapes[k]}: max {(ki - pi).abs().max().item()}")
        err = max(err, float((ki - pi).abs().max()), float((km.long() - pm.long()).abs().max()))
    nbytes, ops = flip_work(*shapes["main"])
    bound_ms, bound_by = bound(nbytes, ops)
    fns = {"ms": lambda: fused_flip_scale(*args["main"]),
           "plain_ms": lambda: fused_flip_scale_reference(*args["main"])}
    late.append({"kernel": "flip_scale", "count": 1, "fns": fns, "symbol": "flip_scale_kernel",
                 "group": 4, "bytes": nbytes, "what": f"flip_scale {shapes['main']}"})
    late.append({"kernel": "flip_scale", "count": 0, "symbol": "flip_scale_kernel", "group": 1,
                 "fns": {"ms": lambda: fused_flip_scale(*args["ragged"])},
                 "what": f"flip_scale {shapes['ragged']}"})
    out = {"ms": cuda_ms(fns["ms"]), "plain_ms": cuda_ms(fns["plain_ms"]),
           "host_ms": host_ms(fns["ms"]), "bound_ms": bound_ms, "bound_by": bound_by,
           "err": err}
    print(f"flip_scale {BATCH}x3x{PATCH}² uint8 + uint8 masks and {FLIP_RAGGED}: bit-equal; "
          f"CUDA events per call: kernel {out['ms'] * 1e3:.1f} us, plain "
          f"{out['plain_ms'] * 1e3:.1f} us; the wrapper holds the host "
          f"{out['host_ms'] * 1e3:.1f} us a call; bound {out['bound_ms'] * 1e3:.1f} us "
          f"({out['bound_by']}, {nbytes / 1e6:.1f} MB); no single PyTorch call computes "
          "it (library time not measured)")
    return out


def train_cli_phase(tmp: Path, tiles: Path, description: str = "trained",
                    epochs: int = TRAIN_EPOCHS, flags: tuple = ()) -> dict:
    """``python -m unet_tpu_torch train [flags]`` in a subprocess (launch
    counts start at 0 there and come back in the stats file); with
    ``--regression`` the history holds rmse and r2_score, with
    ``--lr-finder`` the sweep's steps launch the kernels too and its CSV
    is in the bundle."""
    stats_path = tmp / f"{description}_stats.json"
    cmd = [sys.executable, "-m", "unet_tpu_torch", "train", str(tiles),
           "--model-path", str(tmp / "models"), "--description", description,
           "--codes", "background", "building", "vegetation", "--arch", "xresnet34",
           "--batch-size", str(BATCH), "--epochs", str(epochs), "--lr", "1e-3",
           "--seed", str(SEED), "--stats-json", str(stats_path), *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
    log(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"train exited {proc.returncode}")
    wall = time.perf_counter() - t0
    st = json.loads(stats_path.read_text())
    steps = epochs * (64 // BATCH)
    evals = epochs * -(-16 // BATCH)
    sweep = st["lr_find"]["steps"] if st["lr_find"] else 0
    want = {"bn_sum_sumsq": 43 * (steps + sweep), "bn_bwd_sums": 43 * (steps + sweep),
            "flip_scale": steps + evals + sweep}
    if st["steps"] != steps or st["launches"] != want:
        raise AssertionError(f"train ran {st['steps']} steps, launches {st['launches']}, "
                             f"expected {steps} and {want}")
    metrics = ("rmse", "r2_score") if "--regression" in flags else ("dice_multi",)
    for row in st["history"]:
        if not all(np.isfinite([row["train_loss"], row["valid_loss"],
                                *(row[m] for m in metrics)])):
            raise AssertionError(f"non-finite history row {row}")
    bundle = tmp / "models" / description
    names = [f"{description}.json", f"{description}.msgpack", "best-model.msgpack",
             f"{description}_history.csv", f"{description}_profile.txt"]
    if sweep:
        names.append(f"{description}_lr_find.csv")
    for name in names:
        if not (bundle / name).is_file():
            raise AssertionError(f"bundle lacks {name}")
    ms = st["step_ms"]
    print(f"train CLI {' '.join(flags)}: {steps} steps of {BATCH}x{PATCH}² in {st['seconds']:.2f} s of fit "
          f"({wall:.1f} s with process start); step {float(np.median(ms[1:])):.1f} ms "
          f"median after the first ({ms[0]:.1f} ms); history "
          + "; ".join(f"epoch {r['epoch']}: train {r['train_loss']:.4f} valid "
                      f"{r['valid_loss']:.4f} " + " ".join(f"{m} {r[m]:.4f}" for m in metrics)
                      for r in st["history"])
          + f"; launches {st['launches']}; peak card memory "
          + ("not measured" if st["peak_device_bytes"] is None
             else f"{st['peak_device_bytes'] / 2**30:.2f} GiB"))
    loader = st["loader"]
    if loader["path"] not in ("native", "python"):
        raise AssertionError(f"train loader reports path {loader['path']}")
    print(f"train CLI loader: decode path {loader['path']}; first batch "
          + ", ".join(f"{k} {'not timed' if v is None else f'{v:.1f} ms'}"
                      for k, v in loader["first_batch_ms"].items()))
    return {"bundle": bundle, "launches": st["launches"], "stats": st}


def step_check(trainer, host_batch: tuple, what: str, hold: bool = True) -> tuple:
    """One step with the kernels against one with their plain versions
    (plain bn_stats and plain flip_scale) from the same state, batch and
    augmentation draws, at the trainer's ``grad_accum``: the two batches
    bit-equal, the loss within 1e-3 relative, each parameter's gradient
    within GRAD_REL_L2 relative L2 against at least GRAD_FLOOR of the RMS of
    all gradients (``hold=False``: printed, not held). The state is
    restored after; returns (loss relative error, worst gradient error)."""
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import aug, bn

    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    dev_batch = trainer.to_device(*host_batch)
    x, y = trainer.augment(*dev_batch, "train", torch.Generator().manual_seed(5))
    xp, yp = trainer.augment(*dev_batch, "train", torch.Generator().manual_seed(5),
                             flip_scale=aug.fused_flip_scale_reference)
    if not (torch.equal(x, xp) and torch.equal(y, yp)):
        raise AssertionError(f"{what}: the flip_scale batch differs from its plain version")
    loss_k = trainer.loss_and_grads(x, y).item()
    grads_k = [p.grad.clone() for p in trainer.model.parameters()]
    trainer.model.load_state_dict(state)
    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.reductions = bn.PLAIN_REDUCTIONS
    before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
    try:
        loss_p = trainer.loss_and_grads(xp, yp).item()
    finally:
        for m in bns:
            m.reductions = bn.KERNEL_REDUCTIONS
    if (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches) != before:
        raise AssertionError(f"{what}: the plain step launched a bn_stats kernel")
    # per tensor: RMS error over max(RMS gradient, GRAD_FLOOR × the RMS of
    # all gradients) — some gradients are 0 in exact arithmetic (a
    # BatchNorm scale ahead of another BatchNorm, at zero bias), and
    # there only bf16 rounding noise is left to compare
    named = list(trainer.model.named_parameters())
    sq = sum(float(p.grad.float().pow(2).sum()) for _, p in named)
    g_rms = (sq / sum(p.numel() for _, p in named)) ** 0.5
    rel = []
    for (name, p), gk in zip(named, grads_k):
        rms_p = float(p.grad.norm()) / p.numel() ** 0.5
        err = float((gk - p.grad).norm()) / p.numel() ** 0.5
        rel.append((err / max(rms_p, GRAD_FLOOR * g_rms), name))
    worst = max(rel)
    diff = sum(float((gk - p.grad).pow(2).sum()) for (_, p), gk in zip(named, grads_k))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{what} kernel step vs plain step: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{loss_rel:.2e}); all gradients' relative L2 error {(diff / sq) ** 0.5:.2e}; "
          f"per tensor median {float(np.median([r for r, _ in rel])):.2e}, worst "
          f"{worst[0]:.2e} ({worst[1]}) over {len(rel)} tensors (floor "
          f"{GRAD_FLOOR} of the RMS)")
    trainer.model.load_state_dict(state)
    if hold and (loss_rel > 1e-3 or worst[0] > GRAD_REL_L2):
        raise AssertionError(f"{what}: kernel step and plain step disagree")
    return loss_rel, worst[0]


def train_inprocess_phase(tiles: Path, tmp: Path, steps: int = TRAIN_STEPS,
                          parity: bool = False, **cfg) -> dict:
    """Step time, per-step launch counts, and a kernel step against a plain
    step from the same state, batch and flags; the flagship tpu_opt model,
    or with ``parity`` the parity model with self-attention (γ set to
    SA_GAMMA after the init, so the attention takes part in the step);
    ``cfg`` sets more ``TrainerConfig`` fields (the pipeline's weighted
    focal loss)."""
    from unet_tpu_torch.models.layers import SelfAttention
    from unet_tpu_torch.ops import aug, bn
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    what = ("parity+SA" if parity else "tpu_opt") + "".join(
        f", {k} {v}" for k, v in cfg.items())
    trainer = Trainer(TrainerConfig(
        data_path=tiles, model_path=tmp / "inproc", description="inproc",
        codes=("background", "building", "vegetation"), arch="xresnet34",
        batch_size=BATCH, epochs=1, lr=1e-3, seed=SEED, tpu_opt=not parity,
        self_attention=parity, **cfg))
    try:
        trainer.init_state()
        with torch.no_grad():
            for m in trainer.model.modules():
                if isinstance(m, SelfAttention):
                    m.gamma.fill_(SA_GAMMA)
        host = [b[:2] for b in trainer.train_loader]
        counters = (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale)
        per_step = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(steps):
            for f in counters:
                f.launches = 0
            trainer.train_step(*host[i % len(host)])
            per_step.append(tuple(f.launches for f in counters))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(c != (43, 43, 1) for c in per_step):
            raise AssertionError(f"per-step launches {per_step}, expected (43, 43, 1)")
        ms = trainer.step_ms()
        step_ms = float(np.median(ms[1:]))
        print(f"train in-process, {what}: {steps} steps, {step_ms:.2f} ms per step median "
              f"after the first ({ms[0]:.1f} ms) = {BATCH * 1e3 / step_ms:.1f} tiles/s "
              f"(CUDA events); wall {wall:.2f} s; launches per step "
              f"bn_sum_sumsq/bn_bwd_sums/flip_scale {per_step[-1]}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

        loss_rel, worst = step_check(trainer, host[0], what)
        return {"trainer": trainer, "host": host, "step_ms": step_ms, "loss_rel": loss_rel,
                "grad_worst": worst, "launches": per_step[-1]}
    except BaseException:
        trainer.close()
        raise


def offset_copy_phase(dev, late: list) -> dict:
    """offset_copy bit-equal to its plain version at every offset of a
    (64, 128) source and at the probe's (16, 128), offset 1; an
    out-of-range offset must raise. Timed (CUDA events) beside its plain
    version, one ``index_select`` and an empty kernel, and queued in
    ``late`` for its device time and for ``one_op_checks`` (one device
    operation a call: the status comes back through pinned host memory;
    the kernel's own interval) — traced last, as the profiler slows later
    launches."""
    from unet_tpu_torch.ops.probe import ROWS, COLS, empty_kernel, offset_copy, \
        offset_copy_reference

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    src = torch.randn((64, COLS), generator=g, device=dev)
    probe_src = torch.arange(16 * COLS, dtype=torch.float32, device=dev).view(16, COLS)
    err = 0.0
    for s, o in [(src, o) for o in range(64 // ROWS)] + [(probe_src, 1)]:
        off = torch.tensor([o], dtype=torch.int32, device=dev)
        got, want = offset_copy(s, off), offset_copy_reference(s, off)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"offset_copy differs from its plain version at "
                                 f"offset {o} of {s.shape[0]} rows")
    for o in (-1, 64 // ROWS):
        try:
            offset_copy(src, torch.tensor([o], dtype=torch.int32, device=dev))
        except ValueError:
            continue
        raise AssertionError(f"offset_copy took offset {o} of 64 rows")
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    if not torch.equal(offset_copy(probe_src, off), probe_src[ROWS:2 * ROWS]):
        raise AssertionError("offset_copy of the probe's case is not rows 8-15")
    idx = off.long()
    fns = {"ms": lambda: offset_copy(probe_src, off),
           "plain_ms": lambda: offset_copy_reference(probe_src, off),
           "library_ms": lambda: probe_src.view(-1, ROWS, COLS).index_select(0, idx)}
    late.append({"kernel": "offset_copy", "count": 1, "fns": fns, "symbol": "offset_copy_kernel",
                 "what": f"offset_copy (16, {COLS}) offset 1"})
    out = {k: cuda_ms(fn) for k, fn in fns.items()}
    out["empty_ms"] = cuda_ms(lambda: empty_kernel(dev))
    out["bound_ms"] = bound(*offset_copy_work(ROWS, COLS))[0]
    out["err"] = err
    print(f"offset_copy: bit-equal at every offset of (64, {COLS}) and at the probe's "
          f"(16, {COLS}) offset 1, out-of-range offsets refused; CUDA events per call: "
          f"kernel {out['ms'] * 1e3:.2f} us (waits for the status word), plain "
          f"{out['plain_ms'] * 1e3:.2f} us, index_select {out['library_ms'] * 1e3:.2f} us, "
          f"empty kernel {out['empty_ms'] * 1e3:.2f} us; bytes bound "
          f"{out['bound_ms'] * 1e6:.2f} ns")
    return out


def doctor_phase() -> dict:
    """``doctor --kernels``, the path that runs offset_copy: in this process
    with every launch count at 0 (each kernel must launch exactly once and
    every check pass), then through the CLI in a subprocess (exit 0)."""
    from unet_tpu_torch.ops import aug, blend, bn, probe
    from unet_tpu_torch.utils.doctor import run_doctor

    counters = {"blend_count": blend.blend_and_count, "bn_sum_sumsq": bn.bn_sum_sumsq,
                "bn_bwd_sums": bn.bn_bwd_sums, "flip_scale": aug.fused_flip_scale,
                "offset_copy": probe.offset_copy}
    for f in counters.values():
        f.launches = 0
    results = run_doctor(kernels=True)
    launches = {k: f.launches for k, f in counters.items()}
    if not all(ok for ok, _ in results.values()):
        raise AssertionError(f"doctor --kernels in process: {results}")
    if any(n != 1 for n in launches.values()):
        raise AssertionError(f"doctor --kernels launched {launches}, expected 1 each")
    proc = subprocess.run([sys.executable, "-m", "unet_tpu_torch", "doctor", "--kernels"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    print("python -m unet_tpu_torch doctor --kernels:\n" + proc.stdout.rstrip())
    if proc.returncode != 0:
        log(proc.stderr)
        raise RuntimeError(f"doctor --kernels exited {proc.returncode}")
    print(f"doctor --kernels: every check ok; launches in process {launches}")
    return launches


def pure_python_read(path: Path) -> np.ndarray:
    """A TIFF read by the port's codec with every native hook off."""
    from unet_tpu_torch import native
    from unet_tpu_torch.geo import tiff

    available = native.available
    native.available = lambda: False
    try:
        return tiff.read(str(path))[0]
    finally:
        native.available = available


def native_phase(tmp: Path, tiles: Path) -> dict:
    """The native decoder against the Python codec on every tile of the
    training set and on tiles rewritten with LZW, deflate, PackBits and
    JPEG; the decode ms of a 16-tile batch each way."""
    from unet_tpu_torch import native
    from unet_tpu_torch.data.dataset import TileDataset
    from unet_tpu_torch.data.loader import TileLoader
    from unet_tpu_torch.geo import tiff

    ds = TileDataset(tiles)
    files = ds.train_files + ds.valid_files
    batches = [files[i:i + BATCH] for i in range(0, len(files), BATCH)]
    ld = TileLoader(ds, files, BATCH)
    try:
        for paths in batches:
            ni, nm, _ = ld.make_batch_native(paths)
            pi, pm, _ = ld.make_batch_python(paths)
            if not (ni.dtype == pi.dtype and nm.dtype == pm.dtype
                    and np.array_equal(ni, pi) and np.array_equal(nm, pm)):
                raise AssertionError(f"native and Python batches differ at {paths[0]}")
        ms = {"native": [], "python": []}
        for _ in range(3):
            for paths in batches:
                for way, fn in (("native", ld.make_batch_native), ("python", ld.make_batch_python)):
                    t0 = time.perf_counter()
                    fn(paths)
                    ms[way].append((time.perf_counter() - t0) * 1e3)
    finally:
        ld.close()
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"native decoder: bit-equal to the Python codec on all {len(files)} tiles "
          f"(images and masks); decode of a {BATCH}-tile batch of 3 x {PATCH}² uint8 "
          f"(uncompressed) + masks, median of {len(ms['native'])}: native "
          f"{med['native']:.2f} ms, python {med['python']:.2f} ms")
    codec_dir = tmp / "codecs"
    codec_dir.mkdir()
    arrays = [tiff.read(str(f))[0] for f in files[:4]]
    per_codec = {}
    for compress, kw in (("lzw", {}), ("deflate", {"predictor": True}),
                         ("packbits", {}), ("jpeg", {"quality": 90})):
        paths = []
        for i, a in enumerate(arrays):
            p = codec_dir / f"{compress}_{i}.tif"
            tiff.write(str(p), a, compress=compress, tile=(256, 256) if i % 2 else None, **kw)
            paths.append(p)
        t0 = time.perf_counter()
        raw = native.decode_batch_raw(paths, PATCH, PATCH, 3, np.uint8)
        t_native = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        reads = [tiff.read(str(p))[0] for p in paths]
        t_python = (time.perf_counter() - t0) * 1e3
        for i, p in enumerate(paths):
            got = np.moveaxis(raw[i], 2, 0)
            pure = pure_python_read(p)
            if not np.array_equal(got, reads[i]):
                raise AssertionError(f"native decode of {p.name} differs from the codec")
            gap = int(np.abs(got.astype(np.int16) - pure.astype(np.int16)).max())
            if gap > (2 if compress == "jpeg" else 0) or (
                    compress != "jpeg" and not np.array_equal(got, arrays[i])):
                raise AssertionError(f"{p.name}: native vs pure-Python codec off by {gap}")
        per_codec[compress] = (t_native, t_python)
    print("native decoder: bit-equal to the codec on 4 tiles each of LZW, deflate + "
          "predictor, PackBits and JPEG (strips and 256² tiles; pure-Python JPEG "
          "within 2 levels); ms for 4 tiles native / python: "
          + ", ".join(f"{c} {a:.1f} / {b:.1f}" for c, (a, b) in per_codec.items()))
    return {"batch_ms": med, "codec_ms": per_codec}


@contextlib.contextmanager
def tf32_off():
    """float32 convolutions and matmuls without TF32 inside the block."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def class_agreement(pred, pred32, x: np.ndarray) -> tuple:
    """(share of pixels whose bf16 class equals the float32 one, class map
    shape) on one batch ``x``, TF32 off for the float32 forward."""
    with tf32_off():
        cls16 = pred.predict_batch_device(x, argmax_u8=True)
        cls32 = pred32.predict_batch_device(x, argmax_u8=True)
    return (cls16 == cls32).float().mean().item(), tuple(cls16.shape)


def parity_serve_phase(dev, tmp: Path, transform, crs, hwc: np.ndarray) -> dict:
    """Serve the 4096² scene through a seeded parity + self-attention bundle
    (γ = SA_GAMMA): cold through ``python -m unet_tpu_torch serve`` (class
    map checked, one blend_count launch a batch), then warm in this process
    (tiles/s, the forwards' share, launches), then bf16 against float32
    class maps on 16 windows of 512² and on 16 windows of PARITY_ODD² (a
    side not divisible by 4: the decoder's nearest-resizes)."""
    from unet_tpu_torch.ops.blend import blend_and_count
    from unet_tpu_torch.predict.predict import Predictor, predict_raster
    from unet_tpu_torch.tiling.windows import generate_windows

    bundle = make_bundle(tmp, "parity", parity=True)
    st = serve_cli(bundle, tmp / "scene.tif", tmp / "parity.tif", tmp / "parity_serve.json")
    classes = check_class_map(tmp / "parity.tif", transform, crs)
    windows = generate_windows(SCENE, SCENE, PATCH, 0.2)
    n_batches = -(-len(windows) // BATCH)
    cold_launches = int(st["launches"]["blend_count"])
    if cold_launches != n_batches:
        raise AssertionError(f"parity serve launched blend_count {cold_launches} times for "
                             f"{n_batches} batches")
    fwd = st["forward_ms"]
    print(f"parity serve CLI (cold): {st['windows']} windows in {st['seconds']:.2f} s = "
          f"{st['tiles_per_s']:.1f} tiles/s; forward {float(np.median(fwd[1:])):.1f} ms/batch "
          f"of {BATCH} after one warm batch (first {fwd[0]:.1f} ms); blend_count launches "
          f"{cold_launches}; classes {classes}")
    pred = Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.bfloat16)
    predict_raster(str(bundle), str(tmp / "scene.tif"), None, patch_size=PATCH,
                   batch_size=BATCH, predictor=pred, device=dev)  # warm-up pass
    n_fwd = len(pred.forward_ms())
    blend_and_count.launches = 0
    t0 = time.perf_counter()
    predict_raster(str(bundle), str(tmp / "scene.tif"), str(tmp / "parity_warm.tif"),
                   patch_size=PATCH, batch_size=BATCH, predictor=pred, device=dev)
    warm_s = time.perf_counter() - t0
    warm_launches = blend_and_count.launches
    if warm_launches != n_batches:
        raise AssertionError(f"warm parity serve launched blend_count {warm_launches} times")
    warm_fwd = pred.forward_ms()[n_fwd:]
    print(f"parity warm serve: {warm_s:.2f} s = {len(windows) / warm_s:.1f} tiles/s; forward "
          f"{float(np.median(warm_fwd)):.2f} ms/batch median (CUDA events), the forwards "
          f"{100 * sum(warm_fwd) / 1e3 / warm_s:.1f}% of the wall; blend_count launches "
          f"{warm_launches}")
    pred32 = Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
    agree, _ = class_agreement(pred, pred32, np.stack([hwc[w.indices()] for w in windows[:BATCH]]))
    rng = np.random.default_rng(SEED + 6)
    corners = rng.integers(0, SCENE - PARITY_ODD, (BATCH, 2))
    x_odd = np.stack([hwc[r:r + PARITY_ODD, c:c + PARITY_ODD] for r, c in corners])
    agree_odd, shape_odd = class_agreement(pred, pred32, x_odd)
    print(f"parity bf16 vs float32 class maps: {agree * 100:.3f}% agree on {BATCH} x "
          f"{PATCH}², {agree_odd * 100:.3f}% on {BATCH} x {PARITY_ODD}² (class map "
          f"{shape_odd})")
    if agree < 0.99 or agree_odd < 0.99:
        raise AssertionError(f"parity bf16 agrees with float32 on {agree:.4f} / {agree_odd:.4f}")
    if shape_odd != (BATCH, PARITY_ODD, PARITY_ODD):
        raise AssertionError(f"parity class map at {PARITY_ODD}²: {shape_odd}")
    del pred32
    return {"bundle": bundle, "pred": pred, "launches": cold_launches,
            "warm_launches": warm_launches, "cold_tiles_per_s": st["tiles_per_s"],
            "warm_tiles_per_s": len(windows) / warm_s,
            "forward_ms": float(np.median(warm_fwd))}


def tiers_phase(dev, tmp: Path, bundle: Path, hwc: np.ndarray) -> dict:
    """The 4096² scene through predict_raster's three tiers in float32
    (TF32 off), in this process: the whole-scene mosaic (default budgets),
    the band over the scene in RAM (``device_budget_bytes=0``) and
    ``predict_raster_streamed``. Holds banded == streamed bit for bit; the
    whole-scene tier >= AGREE equal to the banded one and equal wherever
    its top-two margin is >= 1e-5 (it adds a pixel's windows in another
    order); the finalize on the card == the host ``finalize_mosaic`` on the
    whole-scene sums, bit for bit, in all four modes (regression on class
    0's sums); and blend_count == its plain version at the band's offsets
    over the band's batches (most of them wrap from one window row to the
    next), sums, counts and finalized rows bit for bit. Launch counts are
    set to 0 before each tier and read after."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops.blend import (DeviceBand, DeviceMosaic, blend_and_count,
                                          blend_and_count_reference)
    from unet_tpu_torch.predict.merge import finalize_mosaic
    from unet_tpu_torch.predict.predict import (Predictor, band_plan, predict_raster,
                                                predict_raster_streamed)
    from unet_tpu_torch.tiling.windows import generate_windows

    pred32 = Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
    kw = dict(patch_size=PATCH, batch_size=BATCH, predictor=pred32, device=dev)
    scene = str(tmp / "scene.tif")
    windows = generate_windows(SCENE, SCENE, PATCH, 0.2)
    outs, launches = {}, {}
    with tf32_off(), quiet_stdout(tmp / "tiers.log"):
        for tier, extra in (("full", {}), ("banded", {"device_budget_bytes": 0})):
            blend_and_count.launches = 0
            outs[tier] = predict_raster(str(bundle), scene, None, **kw, **extra)[0]
            launches[tier] = blend_and_count.launches
        blend_and_count.launches = 0
        predict_raster_streamed(str(bundle), scene, str(tmp / "tiers_streamed.tif"), **kw)
        launches["streamed"] = blend_and_count.launches
        mosaic = DeviceMosaic(SCENE, SCENE, N_OUT, device=dev)
        for s in range(0, len(windows), BATCH):
            chunk = windows[s:s + BATCH]
            x = np.stack([hwc[w.indices()] for w in chunk])
            if len(chunk) < BATCH:
                x = np.concatenate([x, np.repeat(x[-1:], BATCH - len(chunk), 0)])
            mosaic.add_batch(pred32.predict_batch_device(x)[:len(chunk)],
                             [w.y for w in chunk], [w.x for w in chunk])
    outs["streamed"] = read_raster(tmp / "tiers_streamed.tif").data[0]
    tiers = [r["tier"] for r in pred32.scenes]
    if tiers != ["full", "banded", "streamed"]:
        raise AssertionError(f"tiers taken: {tiers}")
    batches, band_rows = band_plan(windows, BATCH)
    adds = sum(len({w.y for w in b}) for b in batches)  # a batch's window rows
    if launches != {"full": len(batches), "banded": adds, "streamed": adds}:
        raise AssertionError(f"blend_count launches {launches} for {len(batches)} batches "
                             f"and {adds} band adds")
    summed, counter = mosaic.finalize()
    fin_equal = {}
    for name, mode in (("class_map", {}), ("all_classes", {"all_classes": True}),
                       ("specific_class", {"specific_class": 1}),
                       ("regression", {"regression": True})):
        got, _ = mosaic.finish(**mode)
        fin_equal[name] = bool(np.array_equal(got.cpu().numpy(),
                                              finalize_mosaic(summed, counter, **mode)[0]))
    top2 = np.sort(summed / counter, axis=0)[-2:]
    margin = top2[1] - top2[0]
    differ = outs["full"] != outs["banded"]
    agree = 1.0 - float(differ.mean())
    bit_equal = bool(np.array_equal(outs["banded"], outs["streamed"]))
    full_is_host = bool(np.array_equal(outs["full"], finalize_mosaic(summed, counter)[0]))
    # blend_count against its plain version at the band's offsets
    band_k = DeviceBand(band_rows, SCENE, N_OUT, device=dev)
    band_p = DeviceBand(band_rows, SCENE, N_OUT, device=dev, blend=blend_and_count_reference)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    band_equal, wrapping, band_err = True, 0, 0.0
    for k, b in enumerate(batches):
        probs = torch.rand((len(b), N_OUT, PATCH, PATCH), generator=g, device=dev)
        for band in (band_k, band_p):
            band.add_batch(probs, [w.y for w in b], [w.x for w in b])
        band_err = max(band_err, (band_k.sum - band_p.sum).abs().max().item(),
                       (band_k.count - band_p.count).abs().max().item())
        band_equal &= torch.equal(band_k.sum, band_p.sum) and torch.equal(band_k.count,
                                                                          band_p.count)
        wrapping += b[0].y != b[-1].y
        upto = batches[k + 1][0].y if k + 1 < len(batches) else SCENE
        if upto > band_k.top:
            rows_k = band_k.finalize_rows(upto, all_classes=True)[0]
            band_equal &= torch.equal(rows_k, band_p.finalize_rows(upto, all_classes=True)[0])
    torch.cuda.synchronize()
    print(f"tiers at {SCENE}² in float32 (TF32 off): {tiers}, blend_count launches "
          f"{launches} for {len(batches)} batches, {adds} band adds; banded vs streamed "
          f"{'bit-equal' if bit_equal else 'NOT bit-equal'}; whole-scene vs banded "
          f"{100 * agree:.4f}% equal, {int(differ.sum())} pixels differ, largest margin "
          f"there {float(margin[differ].max()) if differ.any() else 0.0:.3g}; the "
          f"whole-scene class map {'equals' if full_is_host else 'differs from'} the host "
          f"finalize of its sums; finalize on the card == host finalize_mosaic: {fin_equal}; "
          f"blend_count at band offsets ({band_rows}-row band, {len(batches)} batches, "
          f"{wrapping} wrapping) {'bit-equal' if band_equal else 'NOT bit-equal'} to plain")
    if not bit_equal:
        raise AssertionError("banded and streamed class maps differ")
    if agree < AGREE or (differ.any() and float(margin[differ].max()) >= 1e-5):
        raise AssertionError(f"whole-scene vs banded: {agree} equal")
    if not all(fin_equal.values()):
        raise AssertionError(f"finalize on the card differs from the host: {fin_equal}")
    if not band_equal or wrapping == 0:
        raise AssertionError(f"blend_count at band offsets: equal {band_equal}, "
                             f"max {band_err}, {wrapping} wrapping batches")
    del pred32, mosaic, band_k, band_p
    return {"launches": launches, "agree": agree, "band_rows": band_rows,
            "wrapping": wrapping, "finalize_equal": fin_equal}


def big_scene(path: Path, img: np.ndarray, transform, crs) -> None:
    """The BIG² 3-band uint8 scene: the 4096² scene tiled and cut to BIG²,
    written as an uncompressed strip GeoTIFF."""
    from unet_tpu_torch.geo import write_raster

    reps = -(-BIG // img.shape[1])
    write_raster(path, np.tile(img, (1, reps, reps))[:, :BIG, :BIG], transform=transform,
                 crs=crs)


def big_serve_phase(dev, tmp: Path, bundle: Path, pred, img: np.ndarray, transform,
                    crs) -> dict:
    """A scene of any size: the BIG² scene with the flagship bundle in bf16.
    Its mosaic (BIG² × 4 × 4 bytes) exceeds the 4 GiB device budget, so the
    default budgets take the band over the scene in RAM. Runs: ``python -m
    unet_tpu_torch serve`` (default budgets) and ``serve --stream`` in
    subprocesses, then in this process with the model resident the banded
    tier and ``predict_raster_streamed``. Holds: the two in-process maps
    bit-equal; each CLI map >= AGREE equal to its in-process twin; every
    pixel a valid class and the scene's georeference;
    blend_count launched once for each add of the banded core (a batch's
    window row) in every run (counts set to 0 before each in-process run;
    a new process for each CLI run). Peak host RSS is sampled
    (``rss_peak``): the CLI process's own, and this process's during each
    in-process run beside its resident set before it."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops.blend import blend_and_count
    from unet_tpu_torch.predict.predict import band_plan, predict_raster, predict_raster_streamed
    from unet_tpu_torch.tiling.windows import generate_windows

    t0 = time.perf_counter()
    scene = tmp / "big.tif"
    big_scene(scene, img, transform, crs)
    scene_s = time.perf_counter() - t0
    batches, band_rows = band_plan(generate_windows(BIG, BIG, PATCH, 0.2), BATCH)
    wrapping = [b for b in batches if b[0].y != b[-1].y]
    n_windows = sum(len(b) for b in batches)
    log(f"{BIG}² scene written in {scene_s:.1f} s")
    runs, maps = {}, {}

    def read_map(path: Path) -> np.ndarray:
        out = read_raster(path)
        if (out.data.dtype != np.uint8 or out.data.shape != (1, BIG, BIG)
                or int(out.data.max()) >= N_OUT):
            raise AssertionError(f"class map {out.data.dtype} {out.data.shape}")
        if tuple(out.transform) != transform or out.crs != crs:
            raise AssertionError(f"georeference {out.transform} {out.crs}")
        return out.data[0]

    for name, extra in (("CLI serve", []), ("CLI serve --stream", ["--stream"])):
        out = tmp / f"big_{len(runs)}.tif"
        st = serve_cli(bundle, scene, out, tmp / f"big_{len(runs)}.json", extra)
        (rec,) = st["scenes"]
        runs[name] = {"seconds": st["seconds"], "tiles_per_s": st["tiles_per_s"],
                      "finalize_s": rec["finalize_s"], "tier": rec["tier"],
                      "adds": rec["adds"], "launches": st["launches"]["blend_count"],
                      "read_s": rec.get("read_s"), "write_s": rec["write_s"],
                      "peak_device_gb": st["peak_device_bytes"] / 1e9,
                      "peak_rss_gb": st["peak_rss_gb"], "rss_before_gb": None}
        maps[name] = read_map(out)
    for name in ("banded in process", "streamed in process"):
        blend_and_count.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rss_before = vm_rss_bytes(os.getpid())
        with rss_peak(os.getpid(), {}) as rss:
            t0 = time.perf_counter()
            if name.startswith("banded"):
                out = tmp / "big_banded.tif"
                maps[name] = predict_raster(str(bundle), str(scene), str(out),
                                            patch_size=PATCH, batch_size=BATCH,
                                            predictor=pred, device=dev)[0]
            else:
                out = tmp / "big_streamed.tif"
                predict_raster_streamed(str(bundle), str(scene), str(out), patch_size=PATCH,
                                        batch_size=BATCH, predictor=pred, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        rec = pred.scenes[-1]
        runs[name] = {"seconds": secs, "tiles_per_s": rec["windows"] / secs,
                      "finalize_s": rec["finalize_s"], "tier": rec["tier"],
                      "adds": rec["adds"], "launches": blend_and_count.launches,
                      "read_s": rec.get("read_s"), "write_s": rec["write_s"],
                      "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_rss_gb": rss["gb"], "rss_before_gb": rss_before / 1e9}
        if name.startswith("banded"):
            read_map(out)
        else:
            maps[name] = read_map(out)
    for name, r in runs.items():
        rss = f"{r['peak_rss_gb']:.2f} GB" + ("" if r["rss_before_gb"] is None else
                                              f" (this process, {r['rss_before_gb']:.2f} GB "
                                              "before the run)")
        read = "" if r["read_s"] is None else f"reading the scene {r['read_s']:.2f} s, "
        print(f"{BIG}² {name}: tier {r['tier']}, {n_windows} windows in {r['seconds']:.2f} s = "
              f"{r['tiles_per_s']:.1f} tiles/s; finalize {r['finalize_s']:.3f} s (device "
              f"time); host {read}writing the map {r['write_s']:.2f} s; blend_count launches "
              f"{r['launches']} for {len(batches)} batches in {r['adds']} adds; peak card "
              f"memory {r['peak_device_gb']:.2f} GB; peak host RSS {rss}")
    equal_in = bool(np.array_equal(maps["banded in process"], maps["streamed in process"]))
    agree = {"CLI serve": float((maps["CLI serve"] == maps["banded in process"]).mean()),
             "CLI serve --stream": float((maps["CLI serve --stream"]
                                          == maps["streamed in process"]).mean())}
    print(f"{BIG}² maps: banded vs streamed in process "
          f"{'bit-equal' if equal_in else 'NOT bit-equal'}; CLI vs in process "
          + ", ".join(f"{k} {100 * v:.4f}%" for k, v in agree.items())
          + f"; {band_rows}-row band, {len(wrapping)} of {len(batches)} batches wrap rows")
    want_tiers = {"CLI serve": "banded", "CLI serve --stream": "streamed",
                  "banded in process": "banded", "streamed in process": "streamed"}
    if any(runs[k]["tier"] != v for k, v in want_tiers.items()):
        raise AssertionError(f"tiers: {({k: r['tier'] for k, r in runs.items()})}")
    adds = sum(len({w.y for w in b}) for b in batches)
    if any(r["launches"] != adds or r["adds"] != adds for r in runs.values()):
        raise AssertionError(f"blend_count launches for {adds} adds: "
                             f"{({k: r['launches'] for k, r in runs.items()})}")
    if not equal_in or min(agree.values()) < AGREE:
        raise AssertionError(f"{BIG}² maps: in process equal {equal_in}, CLI {agree}")
    return {"scene": scene, "runs": runs, "batches": batches, "band_rows": band_rows,
            "wrapping": wrapping, "agree": agree, "scene_s": scene_s}


def wrapping_launch_ms(dev, big: dict) -> dict:
    """blend_count's device time (torch.profiler, the kernel's own
    intervals) at the BIG² band's offsets on random probabilities: a launch
    for a batch within one window row; a launch for a batch that wraps from
    one window row to the next, whole (its bounding box as wide as the
    scene) and split into one launch a window row, as the banded core adds
    it."""
    from unet_tpu_torch.ops.blend import blend_and_count

    band_sum = torch.zeros((N_OUT, big["band_rows"], BIG), device=dev)
    band_count = torch.zeros((big["band_rows"], BIG), device=dev)
    probs = torch.rand((BATCH, N_OUT, PATCH, PATCH), device=dev)

    def launches(b, split):
        rows = np.array([w.y - b[0].y for w in b])
        cols = np.array([w.x for w in b])
        if not split:
            return [(rows, cols, 0, len(b))]
        cut = [i for i in range(1, len(b)) if b[i].y != b[i - 1].y]
        edges = [0, *cut, len(b)]
        return [(rows[i:j], cols[i:j], i, j) for i, j in zip(edges, edges[1:])]

    out = {}
    within = [b for b in big["batches"] if b[0].y == b[-1].y]
    for kind, group, split in (("within a row", within, False),
                               ("wrapping, whole", big["wrapping"], False),
                               ("wrapping, split", big["wrapping"], True)):
        calls = [c for b in group for c in launches(b, split)]

        def run():
            for r, q, i, j in calls:
                blend_and_count(band_sum, band_count, probs[i:j], r, q)

        tr = device_trace(run, f"blend_count {kind}", reps=3)
        kernel_ms = sum(ms for name, ms in tr["by_name"].items() if "blend_count" in name)
        out[kind] = {"batches": len(group), "launches": len(calls),
                     "kernel_ms_per_batch": kernel_ms * len(calls) / len(group)}
    ratio = out["wrapping, whole"]["kernel_ms_per_batch"] / out["within a row"]["kernel_ms_per_batch"]
    print(f"blend_count at the {BIG}² band (torch.profiler, kernel time a batch): "
          + "; ".join(f"{k} {v['kernel_ms_per_batch'] * 1e3:.1f} us ({v['batches']} batches, "
                      f"{v['launches']} launches)" for k, v in out.items())
          + f"; a whole wrapping batch / a batch within a row {ratio:.2f}")
    out["ratio"] = ratio
    return out


def shuffle_as_convt(mod, x: torch.Tensor) -> torch.Tensor:
    """What ``mod`` (a PixelShuffleICNR) computes, as the JAX package's
    ``_ShuffleConv`` formulates it: one k2-s2 transposed conv whose tap
    (dy, dx) is output channel f·4 + dy·2 + dx of the 1x1 kernel, and the
    bias as a per-phase (nf, 2, 2) pattern; then ReLU and the blur. A
    yardstick only; the port computes conv + pixel shuffle."""
    from unet_tpu_torch.models.layers import replication_blur

    weight, bias = mod.conv.weight, mod.conv.bias
    nf, ni = weight.shape[0] // 4, weight.shape[1]
    w = weight.view(nf, 2, 2, ni).permute(3, 0, 1, 2).to(x.dtype)
    y = torch.nn.functional.conv_transpose2d(x, w, stride=2)
    b, _, h2, w2 = y.shape
    y = y.view(b, nf, h2 // 2, 2, w2 // 2, 2) + bias.to(x.dtype).view(1, nf, 1, 2, 1, 2)
    y = torch.relu(y.view(b, nf, h2, w2))
    return replication_blur(y) if mod.blur else y


def shuffle_phase(dev) -> dict:
    """PixelShuffleICNR (1x1 conv + pixel shuffle) against the JAX
    package's formulation of it (one k2-s2 transposed conv with a
    per-phase bias, ``shuffle_as_convt``) at the parity model's five
    upsample shapes (batch 16 × 512², bf16), forward and forward +
    backward, CUDA events; the two must agree (bf16, within 2e-2 of the
    largest output)."""
    from unet_tpu_torch.models.layers import PixelShuffleICNR

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    # (ni, nf, input side, blur): up_0..up_3, then final_shuf
    sites = [(512, 256, PATCH // 32, True), (512, 256, PATCH // 16, True),
             (384, 192, PATCH // 8, True), (256, 128, PATCH // 4, True),
             (96, 96, PATCH // 2, False)]
    tot = {(f, k): 0.0 for f in ("shuffle", "convt") for k in ("fwd", "fwd_bwd")}
    for ni, nf, side, blur in sites:
        mod = PixelShuffleICNR(ni, nf, blur=blur).to(dev)
        with torch.no_grad():
            mod.conv.weight.normal_(0, (2 / ni) ** 0.5, generator=g)
            mod.conv.bias.normal_(0, 0.1, generator=g)
        x = torch.randn((BATCH, ni, side, side), generator=g, device=dev).to(torch.bfloat16)
        x.requires_grad_(True)
        dy = torch.randn((BATCH, nf, 2 * side, 2 * side), generator=g,
                         device=dev).to(torch.bfloat16)
        fns = {"shuffle": mod, "convt": lambda t, mod=mod: shuffle_as_convt(mod, t)}
        with torch.no_grad():
            outs = [fn(x).float() for fn in fns.values()]
        err = float((outs[0] - outs[1]).abs().max() / outs[0].abs().max())
        if err > 2e-2:
            raise AssertionError(f"PixelShuffleICNR formulations differ by {err:.3g} at "
                                 f"({ni}, {side}²)")
        for f, fn in fns.items():
            tot[f, "fwd"] += cuda_ms(lambda fn=fn: fn(x.detach()))
            tot[f, "fwd_bwd"] += cuda_ms(lambda fn=fn: fn(x).backward(dy))
    print(f"PixelShuffleICNR at the parity model's 5 upsamples (batch {BATCH}, bf16, CUDA "
          f"events, summed): the port's conv1x1 + pixel_shuffle fwd {tot['shuffle', 'fwd']:.3f} "
          f"ms, fwd+bwd {tot['shuffle', 'fwd_bwd']:.3f} ms; as one k2-s2 transposed conv "
          f"fwd {tot['convt', 'fwd']:.3f} ms, fwd+bwd {tot['convt', 'fwd_bwd']:.3f} ms")
    return {f"{f}_{k}_ms": v for (f, k), v in tot.items()}


def parity_train_phase(dev, tmp: Path, tiles: Path, transform, crs) -> dict:
    """``python -m unet_tpu_torch train --no-tpu-opt --self-attention`` for
    PARITY_EPOCHS on the tile set (launches 43 a step for each bn_stats
    kernel, one flip_scale a batch), the exported u vectors moved from
    their init, and the bundle serving the scene through the CLI."""
    from unet_tpu_torch.models import build_unet, init_weights
    from unet_tpu_torch.train.checkpoint import load_weights, to_flax_variables

    tr = train_cli_phase(tmp, tiles, "parity_trained", PARITY_EPOCHS,
                         ("--no-tpu-opt", "--self-attention"))
    manifest = json.loads((tr["bundle"] / "parity_trained.json").read_text())
    if manifest["tpu_opt"] is not False or manifest["self_attention"] is not True:
        raise AssertionError(f"parity bundle manifest {manifest}")
    init = to_flax_variables(init_weights(build_unet(**PARITY), torch.Generator()
                                          .manual_seed(SEED)).state_dict())["batch_stats"]
    got = load_weights(tr["bundle"] / "parity_trained.msgpack")["batch_stats"]
    moved = {k: float(np.abs(got["up_1"]["sa"][k] - init["up_1"]["sa"][k]).max())
             for k in ("query_u", "key_u", "value_u")}
    if min(moved.values()) <= 1e-4:
        raise AssertionError(f"the trained u vectors did not move: {moved}")
    serve_inprocess(tr["bundle"], tmp / "scene.tif", tmp / "parity_trained.tif")
    print(f"parity CLI bundle: u vectors moved from their init by {moved}; served the "
          f"{SCENE}² scene: classes {check_class_map(tmp / 'parity_trained.tif', transform, crs)}")
    return tr


def parity_parts_ms(dev, model) -> dict:
    """Forward + backward ms (CUDA events, bf16, training mode) of the
    parity model's self-attention at its input shape (batch 16, 384 ×
    (512/8)²) and of its full-resolution tail (final_shuf, concat with the
    input, the 99-channel last_cross ResBlock, the head) from the decoder's
    /2 output (96 × 256²), each alone."""
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    sa_x = torch.randn((BATCH, 384, PATCH // 8, PATCH // 8), generator=g,
                       device=dev).to(torch.bfloat16)
    y = torch.randn((BATCH, 96, PATCH // 2, PATCH // 2), generator=g,
                    device=dev).to(torch.bfloat16)
    orig = torch.rand((BATCH, 3, PATCH, PATCH), generator=g, device=dev).to(torch.bfloat16)
    sa_x.requires_grad_(True)
    y.requires_grad_(True)

    def sa():
        model.up_1.sa(sa_x).float().square().mean().backward()

    def tail():
        z = model.last_cross(torch.cat([model.final_shuf(y), orig], dim=1))
        model.head(z).float().square().mean().backward()

    model.train()
    out = {"attention_ms": cuda_ms(sa, reps=10), "tail_ms": cuda_ms(tail, reps=10)}
    for p in model.parameters():
        p.grad = None
    return out


def op_device_ms(prof) -> dict:
    """PyTorch op name -> (self device ms, calls) of a ``torch.profiler``
    trace, for the ops that launched device work."""
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if ms > 0:
            out[e.key] = (ms, e.count)
    return out


def run_cli(args: list, what: str, quiet: bool = False, env: dict = None) -> tuple:
    """``python -m unet_tpu_torch <args>`` in a subprocess (``env`` added to
    its environment): (wall seconds, standard output); a nonzero exit
    raises. With ``quiet`` only the last lines of its output are logged."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unet_tpu_torch", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "UNET_TPU_TRACEBACK": "1", **(env or {})})
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    log("\n".join(out.splitlines()[-8:]) if quiet and proc.returncode == 0 else out)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} exited {proc.returncode}")
    return wall, proc.stdout


@contextlib.contextmanager
def quiet_stdout(path: Path):
    """Standard output into ``path`` (the trainers' epoch rows and the
    progress lines of many runs); its tail goes to stderr if the block
    raises."""
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        try:
            yield
        except BaseException:
            f.flush()
            log(path.read_text()[-4000:])
            raise


@contextlib.contextmanager
def timed_calls(targets: list, spent: dict, sync: bool = False):
    """Replace each (owner, attribute) callable with one that adds its
    seconds to ``spent[attribute]``; restored on exit. With ``sync`` the
    card is synchronized before the clock starts (earlier queued work is
    not counted) and before it stops (the call's own device work is)."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in targets]

    def wrap(attr, fn):
        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                spent[attr] = spent.get(attr, 0.0) + time.perf_counter() - t0
        return timed

    for owner, attr, fn in saved:
        setattr(owner, attr, wrap(attr, fn))
    try:
        yield spent
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def tile_phase(tmp: Path, transform, crs) -> dict:
    """``python -m unet_tpu_torch tile`` of the 4096² scene with its labels
    as a mask GeoTIFF (512² tiles, overlap 0.2, split 0.8 / 0.2, seed 0):
    the trai / vali × img_tiles / mask_tiles layout, image and mask names
    paired, every tile 512² on the scene's pixel grid; then the prediction
    tiles with no mask and max_empty 1.0 (every window)."""
    from unet_tpu_torch.geo import tiff, write_raster
    from unet_tpu_torch.tiling.windows import generate_windows

    _, labels = scene_arrays(SCENE, SEED)
    write_raster(tmp / "mask.tif", labels[None], transform=transform, crs=crs)
    pipe, pred = tmp / "pipe", tmp / "pred"
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:  # both at once
        train_tiles = pool.submit(
            run_cli, ["tile", tmp / "scene.tif", "--mask", tmp / "mask.tif", "--base-dir",
                      pipe, "--patch-size", PATCH, "--patch-overlap", "0.2", "--split", "0.8",
                      "0.2", "--seed", SEED], "tile")
        pred_tiles = pool.submit(
            run_cli, ["tile", tmp / "scene.tif", "--base-dir", pred, "--patch-size", PATCH,
                      "--patch-overlap", "0.2", "--max-empty", "1.0"], "tile (prediction tiles)")
        (secs, out), (pred_secs, _) = train_tiles.result(), pred_tiles.result()
    n = int(re.search(r"(\d+) tiles written to", out).group(1))
    split = {}
    for part in ("trai", "vali"):
        names = [sorted(p.name for p in (pipe / part / sub).glob("*.tif"))
                 for sub in ("img_tiles", "mask_tiles")]
        if not names[0] or names[0] != names[1]:
            raise AssertionError(f"{part}: image and mask tiles do not pair up")
        split[part] = len(names[0])
    if sum(split.values()) != n or (pipe / "img_tiles").exists():
        raise AssertionError(f"tile layout {split} against {n} tiles written")
    n_windows = len(generate_windows(SCENE, SCENE, PATCH, 0.2))
    files = sorted(pipe.glob("*/*/*.tif")) + sorted((pred / "img_tiles").glob("*.tif"))
    if len(files) != 2 * n + n_windows:
        raise AssertionError(f"{len(files)} tile files, expected {2 * n} + {n_windows}")
    for f in files:
        info = tiff.read_info(str(f))
        t = info.transform
        col, row = (t[0] - transform[0]) / transform[1], (t[3] - transform[3]) / transform[5]
        if not (info.width == info.height == PATCH and info.crs == crs
                and (t[1], t[2], t[4], t[5]) == tuple(transform[i] for i in (1, 2, 4, 5))
                and abs(col - round(col)) < 1e-6 and abs(row - round(row)) < 1e-6
                and 0 <= round(col) <= SCENE - PATCH and 0 <= round(row) <= SCENE - PATCH):
            raise AssertionError(f"{f.name}: {info.width}x{info.height} at {t} {info.crs}")
    print(f"tile CLI: {n} tiles of {PATCH}² (trai {split['trai']}, vali {split['vali']}) in "
          f"{secs:.2f} s with process start; {n_windows} prediction tiles (no mask, "
          f"max_empty 1.0) in {pred_secs:.2f} s, the two runs side by side; every tile on "
          "the scene's pixel grid")
    return {"pipe": pipe, "pred": pred / "img_tiles", "n": n, "split": split,
            "seconds": secs, "n_pred": n_windows}


def pipeline_train_phase(tmp: Path, pipe: Path) -> dict:
    """Train the flagship on the tiled scene as a reference user does (the
    JAX package's ``train_model`` with ``loss_func="focal"``, which its CLI
    has no flag for): xresnet34 tpu_opt, bf16, batch 16, weighted focal
    loss, flips, PIPE_EPOCHS epoch(s); every launch count set to 0 just
    before and read just after."""
    from unet_tpu_torch.ops import aug, bn
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig, train_model

    cfg = TrainerConfig(data_path=pipe, model_path=tmp / "models", description="pipe",
                        codes=("background", "road", "field"), arch="xresnet34",
                        batch_size=BATCH, epochs=PIPE_EPOCHS, lr=1e-3,
                        class_weights="weighted", loss_func="focal", seed=SEED)
    trainer = Trainer(cfg)
    counters = {"bn_sum_sumsq": bn.bn_sum_sumsq, "bn_bwd_sums": bn.bn_bwd_sums,
                "flip_scale": aug.fused_flip_scale}
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    bundle = train_model(cfg, trainer)
    secs = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    steps = len(trainer.step_ms())
    evals = PIPE_EPOCHS * -(-trainer.dataset.n_valid // BATCH)
    want = {"bn_sum_sumsq": 43 * steps, "bn_bwd_sums": 43 * steps, "flip_scale": steps + evals}
    if launches != want:
        raise AssertionError(f"pipeline train launches {launches}, expected {want}")
    for row in trainer.history:
        if not all(np.isfinite([row["train_loss"], row["valid_loss"], row["dice_multi"]])):
            raise AssertionError(f"non-finite history row {row}")
    ms = trainer.step_ms()
    print(f"pipeline train (weighted focal, flips, bf16): {steps} steps + {evals} validation "
          f"batches in {secs:.2f} s; step {float(np.median(ms[1:])):.1f} ms median after the "
          f"first; class weights {[round(w, 3) for w in trainer.class_weights]}; launches "
          f"{launches}")
    return {"bundle": bundle, "launches": launches, "steps": steps}


def pipeline_predict_phase(dev, tmp: Path, bundle: Path, pred_tiles: Path, pipe: Path,
                           transform, crs) -> dict:
    """``python -m unet_tpu_torch predict --merge`` of the prediction tiles,
    on the host and then with ``--device-merge`` (blend_count): both mosaics
    uint8, 4096², georeferenced like the scene, and >= 99.99% equal to each
    other; the device merge >= 99.99% equal to ``serve`` of the same bundle
    and scene in float32 (TF32 off; the bf16 agreement is printed); then in
    this process with the model resident: each mode's
    tiles/s and merge finalize seconds, and blend_count's launches on the
    device-merge path (counts set to 0 just before); last,
    ``validation_vision`` on the validation tiles of ``pipe`` (their masks
    beside them), tile by tile with the model resident: the printed
    tile-majority confusion matrix sums to the tiles with masks, and its
    diagonal share is printed."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops.blend import DeviceMosaic, blend_and_count
    from unet_tpu_torch.predict import predict as pp
    from unet_tpu_torch.predict.merge import MosaicAccumulator
    from unet_tpu_torch.tiling.windows import generate_windows

    n_tiles = len(list(pred_tiles.glob("*.tif")))
    n_batches = -(-n_tiles // BATCH)
    mosaic = pred_tiles.parent / f"smoke_2026_{bundle.name}_prediction.tif"
    maps, cli_s = {}, {}
    for mode, extra in (("host", []), ("device", ["--device-merge"])):
        cli_s[mode], _ = run_cli(["predict", bundle, pred_tiles, "--merge", "--aoi", "smoke",
                                  "--year", "2026", "--batch-size", BATCH, *extra],
                                 f"predict --merge {' '.join(extra)}", quiet=True)
        classes = check_class_map(mosaic, transform, crs)
        maps[mode] = read_raster(mosaic).data[0]
        mosaic.rename(tmp / f"pipeline_{mode}.tif")
        print(f"predict CLI --merge {' '.join(extra)}: {n_tiles} tiles in {cli_s[mode]:.2f} s "
              f"with process start ({n_tiles / cli_s[mode]:.1f} tiles/s); classes {classes}")
    agree = float((maps["host"] == maps["device"]).mean())
    pred = pp.Predictor(str(bundle), batch_size=BATCH, device=dev)

    def run(mode: str, aoi: str, predictor=pred):
        return pp.save_predictions(str(bundle), str(pred_tiles), merge=True, AOI=aoi,
                                   year="2026", device_merge=mode == "device",
                                   predictor=predictor)

    def serve(predictor):
        return pp.predict_raster(str(bundle), str(tmp / "scene.tif"), None, patch_size=PATCH,
                                 patch_overlap=0.2, batch_size=BATCH, predictor=predictor,
                                 device=dev)[0]

    # serve batches the windows in scene order, predict the tiles in name
    # order: a window sits at another place in its batch, and cuDNN's bf16
    # convolutions round by that place, so the bf16 maps differ where the
    # logits round across a class boundary; in float32 (TF32 off) the two
    # differ only in the order of float32 sums
    agree_serve16 = float((serve(pred) == maps["device"]).mean())
    hwc = np.moveaxis(read_raster(tmp / "scene.tif").data, 0, 2)
    x = np.stack([hwc[w.indices()] for w in generate_windows(SCENE, SCENE, PATCH, 0.2)[:BATCH]])
    base = pred.predict_batch_device(x, argmax_u8=True)
    moved = [float((torch.roll(pred.predict_batch_device(np.roll(x, k, 0), argmax_u8=True),
                               -k, 0) != base).float().mean()) for k in (1, 5, 8)]
    pred32 = pp.Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
    with tf32_off(), quiet_stdout(tmp / "predict_f32.log"):
        served32 = serve(pred32)
        merged32 = read_raster(run("device", "float32", pred32)).data[0]
    agree_serve = float((served32 == merged32).mean())
    del pred32
    print(f"pipeline mosaics: host merge vs device merge {100 * agree:.4f}% equal "
          f"({'bit-equal' if agree == 1.0 else 'not bit-equal'}); device merge vs serve of "
          f"the same bundle and scene {100 * agree_serve:.4f}% in float32 (TF32 off), "
          f"{100 * agree_serve16:.4f}% in bf16 (not held: bf16 rounds by batch place: the "
          f"same {BATCH} windows rolled by 1, 5 and 8 places in their batch change "
          + ", ".join(f"{100 * m:.4f}%" for m in moved) + " of their bf16 class pixels)")
    if agree < AGREE or agree_serve < AGREE:
        raise AssertionError(f"pipeline mosaics agree on {agree} / {agree_serve}")

    warm = {}
    with quiet_stdout(tmp / "predict_warm.log"):
        run("device", "warmup")
        for mode in ("host", "device"):
            blend_and_count.launches = 0
            spent: dict = {}
            # the device merge finalizes on the card (DeviceMosaic.finish)
            targets = ([(MosaicAccumulator, "finalize")] if mode == "host"
                       else [(DeviceMosaic, "finish")])
            with timed_calls(targets, spent, sync=mode == "device"):
                t0 = time.perf_counter()
                run(mode, f"warm{mode}")
                secs = time.perf_counter() - t0
            warm[mode] = {"seconds": secs, "tiles_per_s": n_tiles / secs,
                          "finalize_s": sum(spent.values()),
                          "launches": blend_and_count.launches}
    if warm["device"]["launches"] != n_batches or warm["host"]["launches"] != 0:
        raise AssertionError(f"blend_count launches: device merge "
                             f"{warm['device']['launches']} for {n_batches} batches, host "
                             f"merge {warm['host']['launches']}")
    for mode, w in warm.items():
        print(f"predict --merge in process ({mode} merge, model resident): {n_tiles} tiles in "
              f"{w['seconds']:.2f} s = {w['tiles_per_s']:.1f} tiles/s; merge finalize "
              f"{w['finalize_s']:.3f} s; blend_count launches {w['launches']}")
    validation = validation_vision_check(tmp, bundle, pipe, pred)
    return {"pred": pred, "run": lambda: run("device", "profiled"), "agree": agree,
            "agree_serve": agree_serve, "agree_serve_bf16": agree_serve16, "warm": warm,
            "cli_s": cli_s, "validation": validation,
            "launches": warm["device"]["launches"]}


def validation_vision_check(tmp: Path, bundle: Path, pipe: Path, pred) -> dict:
    """``save_predictions(..., validation_vision=True)`` with the resident
    ``pred`` on a copy of ``pipe``'s validation tiles and masks: the
    matrix it prints is the tile-majority matrix of the tiles it wrote
    against the masks and sums to the tiles with masks; its two figures
    drawn, or skipped with a line where the plotting modules are missing."""
    from unet_tpu_torch.predict import predict as pp
    from unet_tpu_torch.predict.figures import confusion_matrix, tile_majorities
    from unet_tpu_torch.utils.plots import missing_modules

    vdir = tmp / "validation" / "vali"
    for sub in ("img_tiles", "mask_tiles"):
        shutil.copytree(pipe / "vali" / sub, vdir / sub)
    n_masked = len(list((vdir / "mask_tiles").glob("*.tif")))
    t0 = time.perf_counter()
    with quiet_stdout(tmp / "validation.log"):
        folder = pp.save_predictions(str(bundle), str(vdir / "img_tiles"), predictor=pred,
                                     validation_vision=True)
    secs = time.perf_counter() - t0
    printed = (tmp / "validation.log").read_text()
    _, cm = confusion_matrix(*tile_majorities(folder, vdir / "img_tiles"))
    if int(cm.sum()) != n_masked or f"Confusion Matrix:\n{cm}\n" not in printed:
        raise AssertionError(f"validation_vision: matrix {cm.tolist()} for {n_masked} tiles "
                             f"with masks; printed {printed[-2000:]}")
    missing = missing_modules("matplotlib", "seaborn", "pandas")
    pngs = sorted(p.name for p in (folder / "Valid_figures").glob("*.png"))
    if pngs != ([] if missing else ["Confusion_Matrix.png", "classification_report.png"]) \
            or (missing and f"figures skipped, {', '.join(missing)} not installed"
                not in printed):
        raise AssertionError(f"validation figures {pngs} with {missing or 'nothing'} missing")
    diagonal = float(np.trace(cm) / cm.sum())
    report = printed.split("Classification Report:\n", 1)[1].rstrip()
    print(f"predict validation_vision in process (model resident): {n_masked} validation "
          f"tiles with masks in {secs:.2f} s; tile-majority confusion matrix {cm.tolist()} "
          f"(sums to {int(cm.sum())}), diagonal share {diagonal:.4f}; figures "
          f"{', '.join(pngs) if pngs else 'skipped: ' + ', '.join(missing) + ' missing'}; "
          "the report:\n" + report)
    return {"n": n_masked, "diagonal": diagonal, "seconds": secs, "figures": pngs}


def load_aerial_fixture():
    """``tests/aerial_fixture.py`` (numpy only), loaded by path."""
    spec = importlib.util.spec_from_file_location("aerial_fixture",
                                                  ROOT / "tests" / "aerial_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gate_phase(tmp: Path) -> dict:
    """The quality gate of ``tests/test_quality_parity.py`` on the card,
    field for field: ``make_scene(384, seed=4)``, ``split_raster`` (128²,
    overlap 0.2, split 0.8 / 0.2, max_empty 0.9, seed 1; prediction tiles
    with no mask, max_empty 1.0), xresnet18, batch 4, lr 3e-3, weighted
    focal loss, flips, float32; the mosaic from ``save_predictions(merge=
    True)``. Parity at 14 epochs (seed 0) and tpu_opt at 20 (seeds 0, 1)
    must clear dice / mIoU .93 / .93 and .90 / .93; tpu_opt seed 2 is
    measured against the same floors and a miss printed, not held (see
    GATE_RUNS); then tpu_opt seed 0 in bf16, printed only."""
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.predict import save_predictions
    from unet_tpu_torch.tiling import split_raster
    from unet_tpu_torch.train.loop import TrainerConfig, train_model

    fixture = load_aerial_fixture()
    root = tmp / "gate"
    root.mkdir()
    img, cls = fixture.make_scene(GATE_SIZE, seed=4)
    write_raster(root / "scene.tif", img, transform=GATE_TRANSFORM, crs="EPSG:25833")
    write_raster(root / "mask.tif", cls[None], transform=GATE_TRANSFORM, crs="EPSG:25833")
    n = split_raster(str(root / "scene.tif"), str(root / "mask.tif"), str(root / "tiles"),
                     patch_size=GATE_TILE, patch_overlap=0.2, split=[0.8, 0.2],
                     max_empty=0.9, seed=1)
    split_raster(str(root / "scene.tif"), None, str(root / "pred"), patch_size=GATE_TILE,
                 patch_overlap=0.2, max_empty=1.0)
    print(f"quality gate: {n} tiles of {GATE_TILE}² from the {GATE_SIZE}² 5-band uint16 "
          f"scene; cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    results, failed = [], []
    for topology, seed, epochs, bf16, held in GATE_RUNS:
        desc = f"gate_{topology}_s{seed}" + ("_bf16" if bf16 else "")
        t0 = time.perf_counter()
        with quiet_stdout(root / f"{desc}.log"):
            bundle = train_model(TrainerConfig(
                data_path=root / "tiles", model_path=root / "models", description=desc,
                batch_size=4, epochs=epochs, lr=3e-3, arch="xresnet18", codes=GATE_CODES,
                class_weights="weighted", loss_func="focal", bf16=bf16, seed=seed,
                transforms=True, tpu_opt=topology == "tpu_opt"))
            out = save_predictions(str(bundle), str(root / "pred" / "img_tiles"),
                                   merge=True, AOI=desc, year="2026", batch_size=4)
        history = (bundle / f"{desc}_history.csv").read_text().splitlines()
        col = history[0].split(",").index("dice_multi")
        dice = max(float(r.split(",")[col]) for r in history[1:])
        ious, miou = fixture.class_iou(read_raster(out).data[0], cls, len(GATE_CODES))
        floors = None if bf16 else GATE_FLOORS[topology]
        ok = floors is None or (dice >= floors[0] and miou >= floors[1])
        print(f"quality gate {topology} seed {seed} {'bf16' if bf16 else 'float32'} "
              f"{epochs} epochs: dice {dice:.4f}, mosaic mIoU {miou:.4f} (per class "
              f"{[round(float(v), 3) for v in ious.values()]}), "
              + (f"floors {floors[0]} / {floors[1]} {'met' if ok else 'MISSED'}"
                 + ("" if held else " (measured, not held)") if floors
                 else "no floor (measured only)")
              + f"; {time.perf_counter() - t0:.1f} s")
        results.append({"topology": topology, "seed": seed, "bf16": bf16, "epochs": epochs,
                        "dice": dice, "miou": miou, "floors_met": ok, "held": held})
        if held and not ok:
            failed.append(desc)
    if failed:
        raise AssertionError(f"quality gate below its floors: {failed}")
    return {"runs": results, "tf32": bool(torch.backends.cudnn.allow_tf32)}


def surface_trainer(tiles: Path, tmp: Path, **cfg):
    """A Trainer of the flagship (xresnet34 tpu_opt, batch 16, bf16) on
    ``tiles``, with ``cfg`` overriding TrainerConfig fields."""
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    kw = dict(data_path=tiles, model_path=tmp / "surface", description="surface",
              codes=("background", "building", "vegetation"), arch="xresnet34",
              batch_size=BATCH, epochs=1, lr=1e-3, seed=SEED)
    kw.update(cfg)
    return Trainer(TrainerConfig(**kw))


def surface_augment(dev, tiles: Path) -> dict:
    """(a) Every op of the full config on a 16 × 3 × 512² uint8 batch of
    the tile set, and on an int16 3-band batch under reference_quirks
    with n_transform_imgs 0.5 (half the batch augmented, at the
    reference's 255/65535 scale): the kernel path bit-equal to the same
    draws through the plain flip_scale, one flip_scale launch a batch;
    µs a batch (CUDA events) and the share of the plain passes (rot90,
    photometric and dropout) in it."""
    from unet_tpu_torch.data import TileDataset, TileLoader
    from unet_tpu_torch.data import augment as A
    from unet_tpu_torch.ops.aug import fused_flip_scale, fused_flip_scale_reference

    cfg = A.AugmentConfig(**SURFACE_AUG)
    ds = TileDataset(tiles)
    loader = TileLoader(ds, ds.train_files[:BATCH], BATCH)
    try:
        img, msk, _ = next(iter(loader))
    finally:
        loader.close()
    u8, m8 = torch.from_numpy(img).to(dev), torch.from_numpy(msk).to(dev)
    cases = [("uint8, full config", u8, "int8", False, 1.0),
             ("int16 3-band, reference_quirks, n_transform_imgs 0.5",
              u8.to(torch.int16) * 100 + 17, "int16", True, 0.5)]
    out = {}
    for i, (what, x, dtype_str, quirks, frac) in enumerate(cases):
        b, _, h, w = x.shape
        n_aug = A.n_augmented(b, frac, quirks)
        draws = A.draw_augment(b, h, w, cfg, n_aug, torch.Generator().manual_seed(SEED + 20 + i))
        used = {"flips": bool((draws.hflip | draws.vflip).any()),
                "rot90": bool(draws.rot_k.any()), "brightness_contrast": bool(draws.bc.any()),
                "saturation": bool(draws.sat.any()), "dropout": bool(draws.drop.any())}
        if not all(used.values()):
            raise AssertionError(f"augment {what}: the draws leave an op unused: {used}")
        scales = A.sample_scales(b, n_aug, dtype_str, "reference", quirks)
        max_val = A.value_max(dtype_str)

        def run(flip_scale=fused_flip_scale):
            return A.apply_augment(x, m8, draws, scales, cfg, max_val, flip_scale)

        fused_flip_scale.launches = 0
        xk, mk = run()
        launches = fused_flip_scale.launches
        xp, mp = run(fused_flip_scale_reference)
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"augment {what}: {launches} flip_scale launches, expected 1")
        if not (torch.equal(xk, xp) and torch.equal(mk, mp)):
            raise AssertionError(f"augment {what}: the kernel path differs from the plain "
                                 f"one: max {(xk - xp).abs().max().item()}")
        full_us = cuda_ms(run) * 1e3
        xr, mr = A.rot90_pass(x, m8, draws.rot_k)
        rot_us = cuda_ms(lambda: A.rot90_pass(x, m8, draws.rot_k)) * 1e3
        flip_us = cuda_ms(lambda: fused_flip_scale(xr, mr, draws.hflip, draws.vflip,
                                                   scales)) * 1e3
        xf, _ = fused_flip_scale(xr, mr, draws.hflip, draws.vflip, scales)
        photo_us = cuda_ms(lambda: A.photometric_pass(xf, draws, cfg, max_val)) * 1e3
        share = (rot_us + photo_us) / full_us
        out[what] = {"us": full_us, "rot90_us": rot_us, "flip_scale_us": flip_us,
                     "photometric_us": photo_us, "plain_share": share,
                     "launches": launches, "n_aug": n_aug,
                     "scales": sorted(set(scales.tolist()))}
        print(f"augment {what}: {b}x{x.shape[1]}x{h}x{w} {x.dtype}, {n_aug} samples "
              f"augmented, scales {out[what]['scales']}; kernel path bit-equal to the plain "
              f"flip_scale; 1 flip_scale launch; {full_us:.1f} us a batch (CUDA events): "
              f"rot90 {rot_us:.1f} us, flip_scale {flip_us:.1f} us, photometric and "
              f"dropout {photo_us:.1f} us; plain passes {100 * share:.1f}% of the batch")
    return out


def surface_grad_accum(trainer) -> dict:
    """(b) grad_accum 1, 2 and 4 on one trainer with the full augmentation:
    bn_sum_sumsq and bn_bwd_sums launched 43 × grad_accum times a step
    and flip_scale once; the step ms (CUDA events, median after the first)
    and the peak card memory, whole and above what was held before the
    steps (the weights, Adam's moments and earlier phases' state); a kernel
    step against a plain step."""
    from dataclasses import replace

    from unet_tpu_torch.ops import aug, bn

    counters = (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale)
    host = [b[:2] for b in trainer.train_loader]
    out = {}
    for k in GRAD_ACCUMS:
        trainer.cfg = replace(trainer.cfg, grad_accum=k)
        trainer.init_state()
        trainer.step_spans.spans.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the weights, Adam and earlier phases' state
        per_step = []
        for i in range(SURFACE_STEPS):
            for f in counters:
                f.launches = 0
            trainer.train_step(*host[i % len(host)])
            per_step.append(tuple(f.launches for f in counters))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        want = (43 * k, 43 * k, 1)
        if any(c != want for c in per_step):
            raise AssertionError(f"grad_accum {k}: per-step launches {per_step}, "
                                 f"expected {want}")
        ms = trainer.step_ms()
        loss_rel, worst = step_check(trainer, host[0], f"grad_accum {k}")
        out[k] = {"step_ms": float(np.median(ms[1:])), "first_ms": ms[0],
                  "peak_bytes": peak, "step_peak_bytes": peak - held,
                  "launches": per_step[-1], "loss_rel": loss_rel, "grad_worst": worst}
        print(f"grad_accum {k}: step {out[k]['step_ms']:.2f} ms median after the first "
              f"({ms[0]:.1f} ms), peak card memory {peak / 2**30:.2f} GiB, of which "
              f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before "
              f"the steps; launches a step bn_sum_sumsq/bn_bwd_sums/flip_scale "
              f"{per_step[-1]}")
    trainer.cfg = replace(trainer.cfg, grad_accum=1)
    return out


def box_mean(a: np.ndarray, k: int) -> np.ndarray:
    """The mean over a k × k window (k odd) of a 2-D array, edges repeated."""
    p = k // 2
    c = np.pad(np.pad(a.astype(np.float64), p, mode="edge"), ((1, 0), (1, 0)))
    c = c.cumsum(0).cumsum(1)
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)


def make_regression_tiles(tiles: Path, root: Path) -> Path:
    """The tile set's images with a continuous target: the band mean over
    15 × 15 pixels ÷ 255, as float32 mask tiles."""
    import shutil

    from unet_tpu_torch.geo import read_raster, write_raster

    for split in ("trai", "vali"):
        for sub in ("img_tiles", "mask_tiles"):
            (root / split / sub).mkdir(parents=True)
        for f in sorted((tiles / split / "img_tiles").glob("*.tif")):
            shutil.copyfile(f, root / split / "img_tiles" / f.name)
            r = read_raster(f)
            y = (box_mean(r.data.astype(np.float32).mean(0), 15) / 255).astype(np.float32)
            write_raster(root / split / "mask_tiles" / f.name, y[None],
                         transform=r.transform, crs=r.crs)
    return root


def surface_regression_serve(dev, tmp: Path, bundle: Path, scene: Path) -> dict:
    """(c) The regression bundle served over the scene by predict_raster
    (whole-scene mosaic of one channel, blend_count once a batch, 7
    batches): float32 values, no -9999 nodata inside the scene; and on the
    same windows' sums the finalize on the card bit-equal to the host
    finalize_mosaic."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops.blend import DeviceMosaic, blend_and_count
    from unet_tpu_torch.predict.merge import finalize_mosaic
    from unet_tpu_torch.predict.predict import Predictor, predict_raster
    from unet_tpu_torch.tiling.windows import generate_windows

    pred = Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.bfloat16)
    windows = generate_windows(SCENE, SCENE, PATCH, 0.2)
    n_batches = -(-len(windows) // BATCH)
    blend_and_count.launches = 0
    t0 = time.perf_counter()
    predict_raster(str(bundle), str(scene), str(tmp / "regression.tif"), patch_size=PATCH,
                   batch_size=BATCH, predictor=pred, device=dev)
    seconds = time.perf_counter() - t0
    launches = blend_and_count.launches
    if launches != n_batches:
        raise AssertionError(f"regression serve: blend_count launched {launches} times "
                             f"for {n_batches} batches")
    out = read_raster(tmp / "regression.tif").data
    if out.dtype != np.float32 or out.shape != (1, SCENE, SCENE):
        raise AssertionError(f"regression map {out.dtype} {out.shape}")
    if (out == -9999).any() or not np.isfinite(out).all():
        raise AssertionError("regression map has nodata or non-finite values in the scene")
    hwc = np.moveaxis(read_raster(scene).data, 0, 2)
    mos = DeviceMosaic(SCENE, SCENE, 1, device=dev)
    for s in range(0, len(windows), BATCH):
        chunk = windows[s:s + BATCH]
        x = np.stack([hwc[w.indices()] for w in chunk])
        if len(chunk) < BATCH:
            x = np.concatenate([x, np.repeat(x[-1:], BATCH - len(chunk), 0)])
        mos.add_batch(pred.predict_batch_device(x)[:len(chunk)].contiguous(),
                      np.array([w.y for w in chunk]), np.array([w.x for w in chunk]))
    host, nodata = finalize_mosaic(*mos.finalize(), regression=True)
    card, card_nodata = mos.finish(regression=True)
    if not (np.array_equal(card.cpu().numpy(), host) and card_nodata == nodata):
        raise AssertionError("regression: the finalize on the card differs from the host's")
    print(f"regression bundle served the {SCENE}² scene in {seconds:.2f} s: float32, "
          f"values {float(out.min()):.4f}..{float(out.max()):.4f}, no nodata inside; "
          f"blend_count launches {launches} ({n_batches} batches of {BATCH}); the finalize "
          f"on the card bit-equal to the host finalize_mosaic")
    return {"launches": launches, "seconds": seconds}


def xresnet34_state_dict(seed: int) -> dict:
    """A torch xresnet34 body in fastai's module layout and key names
    (``0..2`` stem ConvLayers, ``3`` max pool, ``4..7`` stages of
    ResBlocks with convpath/idpath), its weights from ``seed`` and its
    BatchNorm parameters and statistics moved off their init."""
    from torch import nn

    def conv_layer(ni, nf, ks=3, stride=1, act=True):
        layers = [nn.Conv2d(ni, nf, ks, stride, (ks - 1) // 2, bias=False),
                  nn.BatchNorm2d(nf)]
        return nn.Sequential(*layers, *([nn.ReLU()] if act else []))

    class ResBlock(nn.Module):
        def __init__(self, ni, nf, stride):
            super().__init__()
            self.convpath = nn.Sequential(conv_layer(ni, nf, 3, stride),
                                          conv_layer(nf, nf, 3, act=False))
            idpath = [nn.AvgPool2d(2, ceil_mode=True)] if stride != 1 else []
            if ni != nf:
                idpath.append(conv_layer(ni, nf, 1, act=False))
            self.idpath = nn.Sequential(*idpath)

    torch.manual_seed(seed)
    stages, ni = [], 64
    for s, (n, nf) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        stages.append(nn.Sequential(*[ResBlock(ni if b == 0 else nf, nf,
                                               2 if s > 0 and b == 0 else 1)
                                      for b in range(n)]))
        ni = nf
    body = nn.Sequential(conv_layer(3, 32, stride=2), conv_layer(32, 32), conv_layer(32, 64),
                         nn.MaxPool2d(3, 2, 1), *stages)
    with torch.no_grad():
        for m in body.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return body.state_dict()


def surface_pretrained(tmp: Path, trainers: dict) -> dict:
    """(e) A fastai-named xresnet34 .pth (seed PRETRAINED_SEED) through
    the CLI's ``import-weights`` (in this process) to an .npz; in each
    topology the trainer starts from each file: every grafted tensor
    bit-equal to the source (every encoder layer in parity; the residual
    stages in tpu_opt, whose folded stem keeps the seed's fresh init bit
    for bit), then one train step with a finite loss."""
    from dataclasses import replace

    from unet_tpu_torch.models.torch_import import convert_xresnet_state_dict
    from unet_tpu_torch.train.checkpoint import to_flax_variables

    from unet_tpu_torch.__main__ import cli

    sd = xresnet34_state_dict(PRETRAINED_SEED)
    pth, npz = tmp / "xresnet34.pth", tmp / "xresnet34.npz"
    torch.save(sd, pth)
    t0 = time.perf_counter()
    if cli(["import-weights", str(pth), "--arch", "xresnet34", "-o", str(npz)]) != 0:
        raise RuntimeError("import-weights failed")
    wall = time.perf_counter() - t0
    src_p, src_s = convert_xresnet_state_dict({k: v.numpy() for k, v in sd.items()},
                                              "xresnet34")

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)

    out = {"import_weights_s": wall}
    for topology, trainer in trainers.items():
        host = next(iter(trainer.train_loader))[:2]
        trainer.cfg = replace(trainer.cfg, pretrained_weights=None)
        trainer.set_weights()
        fresh = to_flax_variables(trainer.model.state_dict())
        for src in (pth, npz):
            trainer.cfg = replace(trainer.cfg, pretrained_weights=str(src))
            trainer.init_state()
            got = to_flax_variables(trainer.model.state_dict())
            n_src = n_fresh = 0
            for kind, source in (("params", src_p), ("batch_stats", src_s)):
                got_enc, fresh_enc = dict(leaves(got[kind]["encoder"])), \
                    dict(leaves(fresh[kind]["encoder"]))
                for path, a in leaves(source):
                    if topology == "tpu_opt" and path[0].startswith("stem_"):
                        continue
                    if not np.array_equal(got_enc[path], a):
                        raise AssertionError(f"pretrained {topology} {src.suffix}: "
                                             f"{kind} {'/'.join(path)} differs from the source")
                    n_src += 1
                if topology == "tpu_opt":
                    for path, a in fresh_enc.items():
                        if path[0].startswith("stem_"):
                            if not np.array_equal(got_enc[path], a):
                                raise AssertionError(f"pretrained tpu_opt: {kind} "
                                                     f"{'/'.join(path)} left its fresh init")
                            n_fresh += 1
            loss = float(trainer.train_step(*host))
            if not np.isfinite(loss):
                raise AssertionError(f"pretrained {topology} {src.suffix}: loss {loss}")
            out[f"{topology}{src.suffix}"] = {"grafted": n_src, "fresh_stem": n_fresh,
                                              "loss": loss}
            print(f"pretrained {topology} from {src.suffix}: {n_src} encoder tensors "
                  f"bit-equal to the source, {n_fresh} stem tensors at their fresh init; "
                  f"one step, loss {loss:.5f}")
        trainer.cfg = replace(trainer.cfg, pretrained_weights=None)
    return out


def surface_existing(tiles: Path, tmp: Path, bundle: Path) -> dict:
    """(f) ``existing_model`` on phase 4's tpu_opt bundle from a
    ``tpu_opt=False`` config: the trainer adopts tpu_opt, its first step
    starts from the bundle's weights bit for bit, and the step's loss is
    finite."""
    from unet_tpu_torch.train.checkpoint import bundle_paths, from_flax_variables, load_weights

    trainer = surface_trainer(tiles, tmp, tpu_opt=False, existing_model=str(bundle))
    try:
        if not trainer.cfg.tpu_opt:
            raise AssertionError("existing_model did not adopt the bundle's tpu_opt")
        trainer.init_state()
        want = from_flax_variables(load_weights(bundle_paths(bundle)[2]))
        got = trainer.model.state_dict()
        bad = [k for k, a in want.items()
               if not np.array_equal(got[k].cpu().numpy(), np.asarray(a, np.float32))]
        if bad or set(got) != set(want):
            raise AssertionError(f"existing_model: {len(bad)} tensors differ from the bundle")
        loss = float(trainer.train_step(*next(iter(trainer.train_loader))[:2]))
    finally:
        trainer.close()
    if not np.isfinite(loss):
        raise AssertionError(f"existing_model step loss {loss}")
    print(f"existing_model: adopted tpu_opt from the bundle; all {len(want)} tensors "
          f"bit-equal to it before the first step; step loss {loss:.5f}")
    return {"tensors": len(want), "loss": loss}


def surface_lr_weights(trainer, tmp: Path) -> dict:
    """(d) ``fit`` with ``lr_finder`` (its sweep cut to SWEEP_CHECK_ITERS
    steps, no epoch) leaves the model at the weights a run without the
    finder starts from, bit for bit."""
    import functools
    from dataclasses import replace

    trainer.cfg = replace(trainer.cfg, lr_finder=None)
    trainer.init_state()
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.lr_find = functools.partial(trainer.lr_find, num_it=SWEEP_CHECK_ITERS)
    trainer.cfg = replace(trainer.cfg, lr_finder="valley", epochs=0)
    try:
        with quiet_stdout(tmp / "lr_weights_fit.log"):
            trainer.fit()
    finally:
        del trainer.lr_find
        trainer.cfg = replace(trainer.cfg, lr_finder=None, epochs=1)
    bad = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, start[k])]
    if bad:
        raise AssertionError(f"after the sweep, fit starts from other weights: {bad[:3]}")
    r = trainer.lr_find_result
    print(f"lr_finder in fit: a {r['steps']}-step sweep (lr {r['lr']:.3g}), then fit's "
          f"weights bit-equal to a run without the finder over {len(start)} tensors")
    return {"steps": r["steps"], "tensors": len(start)}


def surface_losses(trainer, tiles: Path, reg_tiles: Path, tmp: Path) -> dict:
    """(g) A kernel step against a plain step with the dice loss, and with
    MSE, L1 and smooth L1 on a regression trainer over the continuous
    targets, held in float32 with TF32 off. In bf16 the dice loss's
    gradients into the encoder sit near the rounding noise that the order
    of a BatchNorm sum moves, so its bf16 step (on the bf16 trainer) is
    printed, not held."""
    from dataclasses import replace

    from unet_tpu_torch.train.losses import build_loss

    out = {}
    host = next(iter(trainer.train_loader))[:2]
    saved = trainer.loss_fn
    trainer.cfg, trainer.loss_fn = replace(trainer.cfg, loss_func="dice"), build_loss("dice")
    try:
        out["dice_bf16"] = step_check(trainer, host, "dice loss, bf16 (not held)", hold=False)
    finally:
        trainer.cfg, trainer.loss_fn = replace(trainer.cfg, loss_func=None), saved
    for data, names, kw in ((tiles, ("dice",), {}),
                            (reg_tiles, ("mse", "l1", "smooth_l1"), {"regression": True})):
        t = surface_trainer(data, tmp, bf16=False, **kw)
        try:
            t.init_state()
            host = next(iter(t.train_loader))[:2]
            with tf32_off():
                for name in names:
                    t.cfg = replace(t.cfg, loss_func=name)
                    t.loss_fn = build_loss(name, regression=t.cfg.regression)
                    out[name] = step_check(t, host, f"{name} loss, float32"
                                           + (", regression" if t.cfg.regression else ""))
        finally:
            t.close()
    return out


def train_surface_phase(dev, tmp: Path, tiles: Path, bundle: Path, scene: Path) -> dict:
    """Phase 8c, the training surface on the flagship at 16 × 512², bf16:
    (a) every augmentation op, (b) grad_accum 1/2/4, fit's fresh weights
    after a sweep, (e) pretrained encoders from .pth and .npz in both
    topologies, (f) existing_model, (g) the other losses, (c)+(d) ``train
    --regression --lr-finder valley`` through the CLI (the sweep of up to
    100 steps, its CSV, rmse and r2_score) with the bundle served; the
    phase's seconds, each part's, and each kernel's launches."""
    from unet_tpu_torch.data import AugmentConfig

    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        parts[name] = time.perf_counter() - t

    out = {}
    part("augment", surface_augment, dev, tiles)
    trainer = surface_trainer(tiles, tmp, aug=AugmentConfig(**SURFACE_AUG))
    parity = surface_trainer(tiles, tmp, tpu_opt=False)
    try:
        part("grad_accum", surface_grad_accum, trainer)
        part("lr_weights", surface_lr_weights, trainer, tmp)
        part("pretrained", surface_pretrained, tmp, {"tpu_opt": trainer, "parity": parity})
        parity.close()
        part("existing", surface_existing, tiles, tmp, bundle)
        part("regression_tiles", make_regression_tiles, tiles, tmp / "regression_tiles")
        reg_tiles = out.pop("regression_tiles")
        part("losses", surface_losses, trainer, tiles, reg_tiles, tmp)
    finally:
        trainer.close()
        parity.close()
    del trainer, parity
    part("regression_cli", train_cli_phase, tmp, reg_tiles, "regression", TRAIN_EPOCHS,
         ("--regression", "--lr-finder", "valley"))
    reg = out.pop("regression_cli")
    sweep = reg["stats"]["lr_find"]
    print(f"LR sweep in the regression CLI run: {sweep['seconds']:.2f} s, {sweep['steps']} "
          f"steps, stopped {'on divergence' if sweep['diverged'] else 'at its end'} with "
          f"{sweep['iterations']} losses; suggestions "
          + ", ".join(f"{m} {v:.3g}" for m, v in sweep["suggestions"].items())
          + f"; lr chosen ({sweep['method']}) {sweep['lr']:.3g}")
    out["regression_cli"] = {"launches": reg["launches"], "sweep": {
        k: sweep[k] for k in ("seconds", "steps", "iterations", "diverged", "suggestions",
                              "lr")}, "history": reg["stats"]["history"]}
    part("regression_serve", surface_regression_serve, dev, tmp, reg["bundle"], scene)
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"train surface phase: {out['seconds']:.1f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return out


RUN_EPOCHS = 2        # phase 9d: `run` trains 2 epochs with a checkpoint each
RESUME_EPOCHS = 3     # the run killed after its first checkpoint, then resumed
DDP_WORLD = 2         # two ranks on the one card, over gloo
DDP_STEPS = 3         # optimizer steps after which the ranks' weights are compared
RUN_CODES = ["background", "road", "field"]


def tile_tree(base: Path) -> dict:
    """{relative path: bytes} of every tile under ``base``."""
    return {str(f.relative_to(base)): f.read_bytes() for f in sorted(base.glob("*/*/*.tif"))}


def run_config(tmp: Path, base_dir: Path, pred_tiles: Path, desc: str, **kw) -> Path:
    """A JSON ``Params`` file for ``python -m unet_tpu_torch run``: the
    scene and its labels tiled as phase 9b tiles them (512², overlap 0.2,
    split 0.8 / 0.2, seed 0; the gate's max_empty 0.9), the flagship
    (the gate's xresnet34, tpu_opt and bf16 by default) trained on them
    with a checkpoint an epoch and the model summary, and 9b's prediction
    tiles predicted and merged on the host. ``visualize_data_example`` and
    ``validation_vision`` keep the reference's defaults (True; the merged
    prediction draws no validation figures, as in the reference)."""
    cfg = dict(Create_tiles=True, Train=True, Predict=True,
               image_path=str(tmp / "scene.tif"), mask_path=str(tmp / "mask.tif"),
               base_dir=str(base_dir), patch_size=PATCH, patch_overlap=0.2, split=[0.8, 0.2],
               data_path=str(base_dir), model_path=str(tmp / "run_models"), description=desc,
               BATCH_SIZE=BATCH, EPOCHS=RUN_EPOCHS, LEARNING_RATE=1e-3, CODES=RUN_CODES,
               checkpoint_every=1, export_model_summary=True, enable_extra_parameters=False,
               predict_path=str(pred_tiles), predict_model=str(tmp / "run_models" / desc),
               AOI="R", year="2026", merge=True, seed=SEED)
    cfg.update(kw)
    path = tmp / f"{desc}.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path


def history_epochs(bundle: Path) -> list:
    lines = (bundle / f"{bundle.name}_history.csv").read_text().splitlines()
    return [int(line.split(",")[0]) for line in lines[1:]]


def run_phase(tmp: Path, tiled: dict, transform, crs) -> dict:
    """(a) ``python -m unet_tpu_torch run`` with the three stages in a
    subprocess (tile tree byte-equal to 9b's, the bundle, the summary and
    two checkpoints, the mosaic; ``visualize_data_example`` on, as the
    reference's defaults have it: the batch's shape and value range printed,
    and the histograms and the loss plot drawn, or skipped with a line each
    where matplotlib is not installed), then the same ``Params`` through
    ``api.main`` in this process with every launch count at 0.
    (b) A ``run`` of RESUME_EPOCHS epochs killed once ``checkpoints/1`` is
    complete, then resumed: its history holds epochs 1.., and its bundle
    serves the scene; a saved-then-restored state bit-equal in this
    process."""
    from unet_tpu_torch import api
    from unet_tpu_torch.ops import aug, blend, bn
    from unet_tpu_torch.train import checkpoint as ckpt
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    from unet_tpu_torch.utils.plots import missing_modules

    out = {}
    t0 = time.perf_counter()
    base = tmp / "run_tiles"
    cfg_path = run_config(tmp, base, tiled["pred"], "run")
    secs, run_out = run_cli(["run", cfg_path], "run", quiet=True)
    shape = (f"Input shape: ({BATCH}, {PATCH}, {PATCH}, 3), "
             f"Output shape: ({BATCH}, {PATCH}, {PATCH})")
    value_range = re.search(r"Examplary value range INPUT: (\d+) to (\d+)\n", run_out)
    if shape not in run_out or not value_range or \
            not 0 <= int(value_range[1]) < int(value_range[2]) <= 255:
        raise AssertionError(f"visualize_data_example's lines: {run_out[:2000]}")
    if tile_tree(base) != tile_tree(tiled["pipe"]):
        raise AssertionError("run's tile tree differs from the tile CLI's")
    bundle = tmp / "run_models" / "run"
    for name in ("run.json", "run.msgpack", "best-model.msgpack", "run_history.csv",
                 "run_model_summary.txt"):
        if not (bundle / name).is_file():
            raise AssertionError(f"run's bundle lacks {name}")
    if ckpt.checkpoint_epochs(bundle / "checkpoints") != [1, 2]:
        raise AssertionError(f"checkpoints {ckpt.checkpoint_epochs(bundle / 'checkpoints')}")
    pngs = ("run_image_plot.png", "run_mask_plot.png", "run_history.png")
    plotting = not missing_modules("matplotlib")
    for name in pngs:
        skipped = f"{bundle / name}: skipped, matplotlib is not installed\n"
        if (bundle / name).is_file() != plotting or (skipped in run_out) == plotting:
            raise AssertionError(f"{name}: drawn {(bundle / name).is_file()}, matplotlib "
                                 f"{'installed' if plotting else 'missing'}")
    mosaic = tiled["pred"].parent / "R_2026_run_prediction.tif"
    classes = check_class_map(mosaic, transform, crs)
    summary = (bundle / "run_model_summary.txt").read_text().split("\n\n")[0]
    print(f"run (Create_tiles, Train, Predict; the reference's visualize_data_example and "
          f"validation_vision) through the CLI: {secs:.1f} s with process start; tile tree "
          f"byte-equal to 9b's ({len(tile_tree(base))} files); history epochs "
          f"{history_epochs(bundle)}; checkpoints [1, 2]; mosaic classes {classes}; the "
          f"batch's lines: {shape!r}, value range {value_range[1]} to {value_range[2]}; "
          f"{', '.join(pngs)} {'drawn' if plotting else 'skipped (no matplotlib), a line each'}"
          "; summary: " + summary.replace("\n", " | "))
    out["cli_s"] = secs
    shutil.rmtree(bundle / "checkpoints")  # about 0.4 GB each: free the disk as we go

    # the same Params in this process, every launch count at 0
    p = api.params_from_json(cfg_path)
    p.base_dir = p.data_path = str(tmp / "main_tiles")
    p.description, p.predict_model = "main", str(tmp / "run_models" / "main")
    counters = {"bn_sum_sumsq": bn.bn_sum_sumsq, "bn_bwd_sums": bn.bn_bwd_sums,
                "flip_scale": aug.fused_flip_scale, "blend_count": blend.blend_and_count}
    for f in counters.values():
        f.launches = 0
    t1 = time.perf_counter()
    with quiet_stdout(tmp / "main_stdout.txt"):
        api.main(p)
    main_s = time.perf_counter() - t1
    launches = {k: f.launches for k, f in counters.items()}
    steps = RUN_EPOCHS * (tiled["split"]["trai"] // BATCH)
    evals = RUN_EPOCHS * -(-tiled["split"]["vali"] // BATCH)
    want = {"bn_sum_sumsq": 43 * steps, "bn_bwd_sums": 43 * steps,
            "flip_scale": steps + evals, "blend_count": 0}
    if launches != want:
        raise AssertionError(f"api.main launches {launches}, expected {want}")
    check_class_map(tiled["pred"].parent / "R_2026_main_prediction.tif", transform, crs)
    shutil.rmtree(tmp / "run_models" / "main" / "checkpoints")
    print(f"api.main in process: {main_s:.1f} s; {steps} steps + {evals} validation batches; "
          f"launches {launches} (the host merge launches no blend_count)")
    out.update(main_launches=launches, main_s=main_s, steps=steps)

    # (b) killed after its first checkpoint, then resumed
    killed = run_config(tmp, base, tiled["pred"], "resumed", Create_tiles=False, Predict=False,
                        EPOCHS=RESUME_EPOCHS)
    rbundle = tmp / "run_models" / "resumed"
    first = rbundle / "checkpoints" / "1" / ckpt.CHECKPOINT_FILE
    t1 = time.perf_counter()
    killed_log = open(tmp / "killed_run.txt", "w")
    proc = subprocess.Popen([sys.executable, "-m", "unet_tpu_torch", "run", str(killed)],
                            cwd=ROOT, stdout=killed_log, stderr=subprocess.STDOUT)
    try:
        while not first.is_file():
            if proc.poll() is not None:
                killed_log.close()
                log((tmp / "killed_run.txt").read_text()[-4000:])
                raise RuntimeError(f"the run to be killed exited {proc.returncode} first")
            if time.perf_counter() - t1 > 600:
                raise RuntimeError("no first checkpoint within 600 s")
            time.sleep(0.02)
        proc.kill()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(60)
        killed_log.close()
    killed_at = time.perf_counter() - t1
    latest = ckpt.latest_checkpoint(rbundle / "checkpoints")
    if latest != 1:
        raise AssertionError(f"the killed run left checkpoint {latest}, expected 1")
    resume_cfg = json.loads(killed.read_text())
    resume_cfg["resume"] = True
    killed.write_text(json.dumps(resume_cfg))
    rsecs, rout = run_cli(["run", killed], "resumed run", quiet=True)
    if "Resumed from epoch 1" not in rout or history_epochs(rbundle) != [1, 2]:
        raise AssertionError(f"resumed run: history epochs {history_epochs(rbundle)}")
    serve_inprocess(rbundle, tmp / "scene.tif", tmp / "resumed.tif")
    rclasses = check_class_map(tmp / "resumed.tif", transform, crs)

    # a saved-then-restored state, bit for bit
    tcfg = TrainerConfig(data_path=base, model_path=tmp / "run_models", description="state",
                         codes=RUN_CODES, arch="xresnet34", batch_size=BATCH, epochs=1,
                         lr=1e-3, seed=SEED)
    t = Trainer(tcfg)
    t2 = Trainer(tcfg)
    try:
        t.init_state()
        t.train_step(*next(iter(t.train_loader))[:2])
        ckpt.save_checkpoint(t.checkpoint_dir(), 1, t.checkpoint_state(1))
        t2.init_state()
        t2.restore_checkpoint(ckpt.load_checkpoint(t2.checkpoint_dir(), 1))
        same = all(torch.equal(a, b) for a, b in zip(t.model.state_dict().values(),
                                                      t2.model.state_dict().values()))
        same &= all(torch.equal(a, b) for a, b in zip(t.optimizer.mu + t.optimizer.nu,
                                                      t2.optimizer.mu + t2.optimizer.nu))
        same &= t.optimizer.count == t2.optimizer.count == 1
    finally:
        t.close()
        t2.close()
    shutil.rmtree(rbundle / "checkpoints")
    shutil.rmtree(tmp / "run_models" / "state")
    if not same:
        raise AssertionError("the restored state differs from the saved one")
    print(f"resume: a {RESUME_EPOCHS}-epoch run killed {killed_at:.1f} s after its start, "
          f"once checkpoints/1 was complete (latest checkpoint {latest}); resumed through "
          f"run in {rsecs:.1f} s, history epochs {history_epochs(rbundle)}; its bundle served "
          f"the scene, classes {rclasses}; a saved-then-restored state (weights, running "
          "statistics, Adam's moments, step) bit-equal")
    out.update(resume_s=rsecs, seconds=time.perf_counter() - t0)
    return out


def ddp_config(tiles: Path, tmp: Path, bf16: bool, batch: int):
    from unet_tpu_torch.train.loop import TrainerConfig

    return TrainerConfig(data_path=tiles, model_path=tmp / "ddp_models", description="ddp",
                         codes=RUN_CODES, arch="xresnet34", batch_size=batch, epochs=1,
                         lr=1e-3, seed=SEED, bf16=bf16)


def ddp_step(trainer) -> dict:
    """One step's loss, gradients and launches from the trainer's first
    batch (this rank's share under a process group), the augmentation drawn
    from a fixed generator."""
    from unet_tpu_torch.ops import aug, bn

    counters = (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale)
    host = next(iter(trainer.train_loader))[:2]
    for f in counters:
        f.launches = 0
    x, y = trainer.augment(*trainer.to_device(*host), "train", torch.Generator().manual_seed(5))
    loss = trainer.loss_and_grads(x, y).item()
    return {"loss": loss, "launches": tuple(f.launches for f in counters),
            "grads": {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()},
            "host": host}


def ddp_rank(rank: int, port: int, tiles: Path, tmp: Path, batch: int) -> None:
    """One of two ranks on the one card (gloo): a float32 step (TF32 off),
    held against the same synchronized step through the plain bn_stats and
    flip_scale (``step_check``), and a bf16 step on its share of the first
    batch, then DDP_STEPS optimizer steps in bf16; results to
    ``ddp_rank<r>.pt``."""
    from unet_tpu_torch.parallel import mesh
    from unet_tpu_torch.train.loop import Trainer

    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", DDP_WORLD, rank, backend="gloo",
                              device="cuda")
        for bf16 in (False, True):
            with contextlib.nullcontext() if bf16 else tf32_off():
                t = Trainer(ddp_config(tiles, tmp, bf16, batch))
                try:
                    t.init_state()
                    r = ddp_step(t)
                    if not bf16:  # the kernels against plain on the 2-rank path
                        r["vs_plain"] = step_check(t, r["host"], f"rank {rank} of "
                                                   f"{DDP_WORLD} (gloo, one card), float32")
                    if bf16:
                        host = r["host"]
                        for _ in range(DDP_STEPS):
                            t.train_step(*host)
                        r["step_ms"] = t.step_ms()
                        r["weights"] = {k: v.cpu() for k, v in t.model.state_dict().items()}
                        r["world"] = mesh.data_size()
                    del r["host"]
                    res["bf16" if bf16 else "fp32"] = r
                finally:
                    t.close()
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, tmp / f"ddp_rank{rank}.pt")


def grad_errors(got: dict, want: dict) -> tuple:
    """(worst, median) per-tensor relative L2 error of ``got`` against
    ``want``, against at least GRAD_FLOOR of the RMS of all gradients."""
    sq = sum(float(w.pow(2).sum()) for w in want.values())
    g_rms = (sq / sum(w.numel() for w in want.values())) ** 0.5
    rel = sorted((float((got[k] - w).norm()) / max(float(w.norm()),
                                                    GRAD_FLOOR * g_rms * w.numel() ** 0.5), k)
                 for k, w in want.items())
    return rel[-1], float(np.median([r for r, _ in rel]))


def ddp_phase(tmp: Path, tiles: Path) -> dict:
    """(c) Two ranks on the one card over gloo, a global batch of BATCH
    with BATCH / 2 a rank: per rank (43, 43, 1) launches a step; the
    2-rank float32 step (TF32 off) against the same step through the plain
    versions and against one process's step on the same BATCH tiles (loss
    1e-3 relative, gradients GRAD_REL_L2 with the GRAD_FLOOR floor), the
    bf16 one printed; after DDP_STEPS steps the ranks' weights bit-equal;
    each rank's step ms. Two ranks on one card under NCCL raise. Then
    ``train --coordinator --num-processes 2 --process-id i`` through the
    CLI for 1 epoch, gloo asked for through UNET_TPU_TORCH_BACKEND: only
    rank 0 writes a bundle."""
    import multiprocessing

    from unet_tpu_torch.parallel import mesh
    from unet_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    one = {}
    for bf16 in (False, True):
        with contextlib.nullcontext() if bf16 else tf32_off():
            t = Trainer(ddp_config(tiles, tmp, bf16, BATCH))
            try:
                t.init_state()
                one["bf16" if bf16 else "fp32"] = ddp_step(t)
            finally:
                t.close()
    ctx = multiprocessing.get_context("spawn")
    port = mesh.free_port()
    procs = [ctx.Process(target=ddp_rank, args=(r, port, tiles, tmp, BATCH))
             for r in range(DDP_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    if alive:
        raise RuntimeError(f"ranks {alive} did not finish")
    ranks = [torch.load(tmp / f"ddp_rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    for r in range(DDP_WORLD):
        (tmp / f"ddp_rank{r}.pt").unlink()
    for r, res in enumerate(ranks):
        if "error" in res:
            log(res["error"])
            raise RuntimeError(f"rank {r} failed")
    out = {"launches": [], "step_ms": [],
           "vs_plain": [ranks[r]["fp32"]["vs_plain"] for r in range(DDP_WORLD)]}
    for key, hold in (("fp32", True), ("bf16", False)):
        r0, r1 = ranks[0][key], ranks[1][key]
        if r0["loss"] != r1["loss"] or any(not torch.equal(r0["grads"][k], r1["grads"][k])
                                           for k in r0["grads"]):
            raise AssertionError(f"{key}: the ranks' reduced gradients differ")
        for r in (r0, r1):
            if r["launches"] != (43, 43, 1):
                raise AssertionError(f"{key}: a rank's step launched {r['launches']}")
        loss_rel = abs(r0["loss"] - one[key]["loss"]) / abs(one[key]["loss"])
        (worst, name), median = grad_errors(r0["grads"], one[key]["grads"])
        print(f"2 ranks (gloo, one card) vs 1 process, {key} step on the same {BATCH} tiles"
              f"{', TF32 off' if key == 'fp32' else ''}: loss {r0['loss']:.6f} vs "
              f"{one[key]['loss']:.6f} (rel {loss_rel:.2e}); gradients per tensor median "
              f"{median:.2e}, worst {worst:.2e} ({name}); launches per rank {r0['launches']}"
              + ("" if hold else " (printed, not held)"))
        if hold and (loss_rel > 1e-3 or worst > GRAD_REL_L2):
            raise AssertionError(f"{key}: the 2-rank step disagrees with one process's")
        out[f"{key}_loss_rel"], out[f"{key}_grad_worst"] = loss_rel, worst
    print("2 ranks (gloo, one card), float32 synchronized step with the kernels vs with "
          "their plain versions (bn_stats, flip_scale), held to the bars above: "
          + "; ".join(f"rank {r} loss rel {lr:.2e}, worst gradient {w:.2e}"
                      for r, (lr, w) in enumerate(out["vs_plain"])))
    w0, w1 = ranks[0]["bf16"]["weights"], ranks[1]["bf16"]["weights"]
    if any(not torch.equal(w0[k], w1[k]) for k in w0):
        raise AssertionError(f"after {DDP_STEPS} steps the ranks' weights differ")
    for r, res in enumerate(ranks):
        ms = res["bf16"]["step_ms"]
        out["step_ms"].append(float(np.median(ms[1:])))
        out["launches"].append(res["bf16"]["launches"])
        print(f"rank {r} of 2 sharing one card (gloo reduces CUDA tensors through host "
              f"copies; not a scaling figure): bf16 step of {BATCH // DDP_WORLD} tiles "
              f"{out['step_ms'][-1]:.1f} ms median after the first "
              f"({', '.join(f'{m:.1f}' for m in ms)} ms)")
    print(f"after {DDP_STEPS} bf16 steps the ranks' weights and running statistics are "
          "bit-equal")

    # NCCL refuses two ranks on one card: the port raises, naming gloo,
    # before it forms a group, and the CLI below asks for gloo
    try:
        mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", DDP_WORLD, 0, device="cuda")
    except ValueError as e:
        if "gloo" not in str(e):
            raise
        refusal = str(e)
    else:
        raise AssertionError("two ranks on one card under NCCL were not refused")

    # the CLI, two processes
    port = mesh.free_port()
    cmd = [sys.executable, "-m", "unet_tpu_torch", "train", str(tiles), "--model-path",
           str(tmp / "ddp_cli"), "--description", "ddp", "--codes", *RUN_CODES, "--arch",
           "xresnet34", "--batch-size", str(BATCH), "--epochs", "1", "--lr", "1e-3", "--seed",
           str(SEED), "--coordinator", f"127.0.0.1:{port}", "--num-processes",
           str(DDP_WORLD)]
    t1 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(r), "--stats-json",
                                     str(tmp / f"ddp_cli_{r}.json")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**os.environ, "UNET_TPU_TRACEBACK": "1",
                                              mesh.BACKEND_ENV: "gloo"})
             for r in range(DDP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    cli_s = time.perf_counter() - t1
    if [p.returncode for p in procs] != [0] * DDP_WORLD:
        log("\n".join(outs))
        raise RuntimeError(f"train over 2 processes exited {[p.returncode for p in procs]}")
    if not (tmp / "ddp_cli" / "ddp" / "ddp.msgpack").is_file() or \
            (tmp / "ddp_cli_1.json").exists() or "Model bundle exported" in outs[1]:
        raise AssertionError("train over 2 processes: rank 0 alone must write the bundle")
    st = json.loads((tmp / "ddp_cli_0.json").read_text())
    steps = st["steps"]
    evals = -(-len(list((tiles / "vali" / "img_tiles").glob("*.tif"))) // BATCH)
    want = {"bn_sum_sumsq": 43 * steps, "bn_bwd_sums": 43 * steps, "flip_scale": steps + evals}
    if st["launches"] != want:
        raise AssertionError(f"rank 0 of the CLI launched {st['launches']}, expected {want}")
    print(f"train --coordinator --num-processes 2 through the CLI: {cli_s:.1f} s with process "
          f"start; {steps} steps of {BATCH // DDP_WORLD} tiles a rank; rank 0 launches "
          f"{st['launches']}; history {st['history'][0]['dice_multi']:.4f} dice; one bundle "
          f"(rank 0's), over gloo ({mesh.BACKEND_ENV}=gloo); without it: {refusal}")
    out.update(cli_launches=st["launches"], cli_s=cli_s, seconds=time.perf_counter() - t0,
               one_fp32=one["fp32"])  # phase 12 holds its spatial step against it
    return out


def mesh_doctor_phase() -> dict:
    """(d) ``doctor``'s mesh check on the card: NCCL, world 1, ok."""
    from unet_tpu_torch.utils.doctor import run_doctor

    results = run_doctor()
    ok, detail = results["mesh"]
    if not (ok and "world of 1" in detail and "backend nccl" in detail):
        raise AssertionError(f"doctor's mesh check: {results['mesh']}")
    if not all(ok for ok, _ in results.values()):
        raise AssertionError(f"doctor: {results}")
    return {"mesh": detail}


ART_INT8_RATIO = 0.35  # int8 / float artifact bytes, the JAX package's bar (tests/test_artifact.py)
ART_INT8_AGREE = 0.97  # int8 artifact class agreement with the live bundle (tests/test_artifact.py)
ART_PROB_ATOL = 1e-5   # float32 artifact against the live bundle, TF32 off
ART_SLOW = 1.5         # a warm artifact forward past this multiple of the bundle's is traced
VARIANTS = ("", "slice:8", "group:32")  # phase 11d's UNET_TPU_BN values ("" = unset)
SLICE_K = 8
VARIANT_STEPS = 3      # timed steps of each variant and of remat on/off


def artifact_export_phase(tmp: Path, bundle: Path) -> dict:
    """11a: ``python -m unet_tpu_torch export`` of ``bundle`` to a float
    artifact (``--platforms cpu,cuda``) and an int8 one, the two processes
    side by side: each one's wall seconds and printed export seconds, the
    artifact's bytes, its program's and its weights' bytes; int8 below
    ART_INT8_RATIO of the float artifact, the program under 10% of the
    weights."""
    arts = {"float": tmp / "flagship.uta", "int8": tmp / "flagship_int8.uta"}
    extra = {"float": ["--platforms", "cpu,cuda"], "int8": ["--quantize", "int8"]}
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futs = {k: pool.submit(run_cli, ["export", bundle, path, *extra[k]], f"export {k}",
                               True) for k, path in arts.items()}
        runs = {k: f.result() for k, f in futs.items()}
    out = {"paths": arts}
    for k, path in arts.items():
        wall, stdout = runs[k]
        said = re.search(r"MB, ([0-9.]+) s\)", stdout)
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["__utaot__"]).decode("utf-8"))
            program = z["__program__"].nbytes
            weights = sum(z[n].nbytes for n in z.files if n[0] in "ws")
            n_values = sum(z[n].size for n in z.files if n[0] == "w")
        out[k] = {"bytes": path.stat().st_size, "program_bytes": program,
                  "weights_bytes": weights, "values": n_values, "wall_s": wall,
                  "export_s": float(said.group(1)) if said else None,
                  "platforms": header["platforms"], "dtype": header["dtype"]}
        print(f"export {k} (CLI, {header['dtype']}, platforms {header['platforms']}): "
              f"{wall:.1f} s with process start, export {out[k]['export_s']} s; artifact "
              f"{out[k]['bytes']} bytes: program {program}, weights {weights} "
              f"({n_values} values, {len(header['quantized'])} leaves int8)")
    ratio = out["int8"]["bytes"] / out["float"]["bytes"]
    out["int8_ratio"] = ratio
    print(f"int8 / float artifact bytes {ratio:.4f} (bar < {ART_INT8_RATIO}); program / "
          f"weights {out['float']['program_bytes'] / out['float']['weights_bytes']:.4f}")
    if ratio >= ART_INT8_RATIO:
        raise AssertionError(f"int8 artifact is {ratio:.3f} of the float one")
    if out["float"]["program_bytes"] > 0.1 * out["float"]["weights_bytes"]:
        raise AssertionError("the program is not under 10% of the weights")
    return out


def serve_map(pred, scene: Path, out=None, streamed: bool = False, **kw):
    """``predict_raster`` (or ``predict_raster_streamed``) of ``scene``
    through ``pred`` in this process: (output, seconds, blend_count
    launches, the scene's record), the launch count set to 0 just before."""
    from unet_tpu_torch.ops.blend import blend_and_count
    from unet_tpu_torch.predict import predict as pp

    blend_and_count.launches = 0
    t0 = time.perf_counter()
    if streamed:
        pp.predict_raster_streamed(None, str(scene), str(out), patch_size=PATCH,
                                   batch_size=BATCH, predictor=pred, device=pred.device)
        arr = None
    else:
        arr = pp.predict_raster(None, str(scene), None if out is None else str(out),
                                patch_size=PATCH, batch_size=BATCH, predictor=pred,
                                device=pred.device, **kw)[0]
    torch.cuda.synchronize()
    return arr, time.perf_counter() - t0, blend_and_count.launches, pred.scenes[-1]


def forward_split(preds: dict, x: np.ndarray) -> dict:
    """Each predictor's median forward of the batch ``x`` over 5 (CUDA
    events), then one forward under torch.profiler: wall ms (to a
    synchronize), the card's busy ms (the union of its traced intervals)
    and the host's top ops by self CPU time, printed."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, pred in preds.items():
        median = cuda_ms(lambda pred=pred: pred.predict_batch_device(x), reps=5)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pred.predict_batch_device(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n_dev = device_busy_s(prof)
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
        out[name] = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3, "device_events": n_dev,
                     "median_ms": median,
                     "top_host_ms": [(e.key, e.self_cpu_time_total / 1e3) for e in top]}
        print(f"{name} forward of {len(x)} × {PATCH}²: median {median:.2f} ms over 5 (CUDA "
              f"events); one under torch.profiler: wall "
              f"{wall * 1e3:.2f} ms, card busy {busy * 1e3:.2f} ms over {n_dev} device events "
              f"({100 * busy / wall:.1f}% of the wall); top host ops by self CPU: "
              + "; ".join(f"{k[:48]} {ms:.2f} ms" for k, ms in out[name]["top_host_ms"]))
    return out


def artifact_serve_phase(dev, tmp: Path, bundle: Path, arts: dict, transform, crs,
                         live_cli: dict, pred_tiles: Path) -> dict:
    """11b: the 4096² scene through the float artifact. Cold through
    ``python -m unet_tpu_torch serve`` (the whole tier) and, after each
    one's load and first batch are timed, warm in this process (whole
    tier, streamed, ``--tta``) beside the live bundle's warm serves:
    tiles/s, blend_count launches (one a batch on the whole tier, one an
    add on the band), the bf16 maps >= AGREE equal to the bundle's through
    the same batches; in float32 with TF32 off an artifact exported here
    against a float32 ``Predictor``: class maps all equal, probabilities
    within ART_PROB_ATOL; the int8 artifact's class agreement with the
    bundle > ART_INT8_AGREE. 11c's ``predict`` CLI runs beside the float32
    export and the loads (``out["predict_cli"]``: its seconds and
    output)."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.predict import predict as pp
    from unet_tpu_torch.predict.artifact import export_artifact, load_artifact
    from unet_tpu_torch.tiling.windows import generate_windows

    scene = tmp / "scene.tif"
    n_win = len(generate_windows(SCENE, SCENE, PATCH, 0.2))
    n_batches = -(-n_win // BATCH)
    out = tmp / "art_cold.tif"
    t0 = time.perf_counter()
    stats = serve_cli(arts["float"], scene, out, tmp / "art_cold.json")
    cli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    live = pp.Predictor(str(bundle), batch_size=BATCH, device=dev)
    torch.cuda.synchronize()
    load_s = {"bundle": time.perf_counter() - t0}
    t0 = time.perf_counter()
    art = load_artifact(str(arts["float"]), batch_size=BATCH, device=dev)
    torch.cuda.synchronize()
    load_s["artifact"] = time.perf_counter() - t0
    x0 = read_raster(scene).data[:, :PATCH, :PATCH].transpose(1, 2, 0)[None].repeat(BATCH, 0)
    for name, pred in (("bundle", live), ("artifact", art)):
        t0 = time.perf_counter()
        pred.predict_batch(x0)
        load_s[f"{name}_first_batch"] = time.perf_counter() - t0
    classes = check_class_map(out, transform, crs)
    rec = stats["scenes"][0]
    if stats["launches"]["blend_count"] != n_batches or rec["tier"] != "full":
        raise AssertionError(f"artifact serve CLI: tier {rec['tier']}, blend_count "
                             f"{stats['launches']['blend_count']} for {n_batches}")
    cold = {"tiles_per_s": stats["tiles_per_s"], "seconds": stats["seconds"], "cli_s": cli_s,
            "launches": stats["launches"]["blend_count"], "map": read_raster(out).data[0]}
    print(f"artifact serve CLI (bf16): {stats['tiles_per_s']:.1f} tiles/s over "
          f"{stats['seconds']:.2f} s of serve, {cli_s:.2f} s with process start and load "
          f"(phase 4's CLI serve of a bundle: "
          f"{live_cli['tiles_per_s']:.1f} tiles/s); tier {rec['tier']}; blend_count launches "
          f"{cold['launches']}; peak card memory "
          f"{(stats['peak_device_bytes'] or 0) / 1e9:.2f} GB; classes {classes}")
    print("load seconds in process: "
          + ", ".join(f"{k} {v:.2f}" for k, v in load_s.items()))
    warm = {}
    for name, pred in (("bundle", live), ("artifact", art)):  # each after its first batch
        arr, secs, n, rec = serve_map(pred, scene)
        warm[name] = {"map": arr, "seconds": secs, "tiles_per_s": n_win / secs, "launches": n,
                      "forward_ms": float(np.median(pred.forward_ms()[-n_batches:]))}
        if n != n_batches or rec["tier"] != "full":
            raise AssertionError(f"warm {name} serve: tier {rec['tier']}, {n} launches")
    for name, pred in (("bundle_stream", live), ("artifact_stream", art)):
        out = tmp / f"{name}_warm.tif"
        _, secs, n, rec = serve_map(pred, scene, out, streamed=True)
        warm[name] = {"seconds": secs, "tiles_per_s": n_win / secs, "launches": n,
                      "map": read_raster(out).data[0]}
        if n != rec["adds"]:
            raise AssertionError(f"streamed {name} serve: {n} launches, {rec['adds']} adds")
    n_stream = warm["artifact_stream"]["launches"]
    slow = warm["artifact"]["forward_ms"] / warm["bundle"]["forward_ms"]
    print(f"float artifact's warm forward {slow:.2f}x the bundle's"
          + (f" (past {ART_SLOW}x: one forward of each is traced in phase 10, where the "
             "profiler runs)" if slow > ART_SLOW else f" (traced past {ART_SLOW}x: not traced)"))
    tta = {}
    art_tta = copy.copy(art)  # the loaded program and weights; the flips compose outside
    art_tta.tta = True
    for name, pred in (("bundle", pp.Predictor(str(bundle), batch_size=BATCH, device=dev,
                                               tta=True)),
                       ("artifact", art_tta)):
        arr, secs, n, _ = serve_map(pred, scene)
        tta[name] = {"map": arr, "seconds": secs, "tiles_per_s": n_win / secs, "launches": n}
    # the same windows in the same batches: the streamed tier batches them
    # in (y, x) order, so a stream is held against the bundle's stream
    # (bf16 rounds by a window's place in its batch)
    agree = {
        "warm_vs_bundle": float((warm["artifact"]["map"] == warm["bundle"]["map"]).mean()),
        "stream_vs_bundle_stream": float((warm["artifact_stream"]["map"]
                                          == warm["bundle_stream"]["map"]).mean()),
        "cold_vs_bundle": float((cold["map"] == warm["bundle"]["map"]).mean()),
        "tta_vs_bundle_tta": float((tta["artifact"]["map"] == tta["bundle"]["map"]).mean()),
    }
    stream_vs_whole = float((warm["artifact_stream"]["map"] == warm["artifact"]["map"]).mean())
    for name, w in (("bundle", warm["bundle"]), ("artifact", warm["artifact"]),
                    ("bundle --stream", warm["bundle_stream"]),
                    ("artifact --stream", warm["artifact_stream"]),
                    ("bundle --tta", tta["bundle"]), ("artifact --tta", tta["artifact"])):
        print(f"warm serve in process, {name} (bf16): {w['seconds']:.2f} s = "
              f"{w['tiles_per_s']:.1f} tiles/s; blend_count launches {w['launches']}"
              + (f"; a forward's median {w['forward_ms']:.2f} ms (CUDA events)"
                 if "forward_ms" in w else ""))
    print("artifact bf16 class maps equal to the bundle's: " + ", ".join(
        f"{k} {100 * v:.4f}%" for k, v in agree.items())
        + f" (streamed against whole-tier, other batches: {100 * stream_vs_whole:.4f}%, "
        "not held)")
    if min(agree.values()) < AGREE:
        raise AssertionError(f"artifact maps agree {agree}")

    # float32, TF32 off: an artifact exported in this process, on the card;
    # 11c's predict CLI runs beside the export and the loads
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        predict_run = pool.submit(
            run_cli, ["predict", arts["float"], pred_tiles, "--merge", "--device-merge",
                      "--aoi", "art", "--year", "2026", "--batch-size", BATCH],
            "predict --merge --device-merge with the artifact", True)
        t0 = time.perf_counter()
        art32_path = export_artifact(str(bundle), str(tmp / "flagship_f32.uta"),
                                     dtype=torch.float32, device=dev)
        export32_s = time.perf_counter() - t0
        art32 = load_artifact(str(art32_path), batch_size=BATCH, device=dev)
        live32 = pp.Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
        art8 = load_artifact(str(arts["int8"]), batch_size=BATCH, device=dev)
        predict_cli = predict_run.result()
    with tf32_off():
        p_art = serve_map(art32, scene, all_classes=True)[0]
        p_live = serve_map(live32, scene, all_classes=True)[0]
    prob_err = float(np.abs(p_art - p_live).max())
    cls_equal = float((p_art.argmax(0) == p_live.argmax(0)).mean())
    print(f"float32 artifact (exported in process in {export32_s:.1f} s) vs float32 bundle, "
          f"TF32 off, 4096² all-class mosaic: max |Δp| {prob_err:.3e}, class maps "
          f"{100 * cls_equal:.4f}% equal")
    if prob_err > ART_PROB_ATOL or cls_equal < 1.0:
        raise AssertionError(f"float32 artifact: max |dp| {prob_err}, classes {cls_equal}")

    arr8, secs8, _, _ = serve_map(art8, scene)
    agree8 = float((arr8 == warm["bundle"]["map"]).mean())
    print(f"int8 artifact serve (bf16 compute): {n_win / secs8:.1f} tiles/s; class maps "
          f"{100 * agree8:.4f}% equal to the bundle's (bar > {100 * ART_INT8_AGREE:.0f}%)")
    if agree8 <= ART_INT8_AGREE:
        raise AssertionError(f"int8 artifact agrees on {agree8}")
    return {"art32": art32, "live32": live32, "predict_cli": predict_cli,
            "cold": cold, "warm": warm, "tta": tta, "slow": slow,
            "split_preds": ({"artifact": art, "bundle": live, "x": x0} if slow > ART_SLOW
                            else None),
            "agree": agree, "prob_err": prob_err, "agree_int8": agree8,
            "export32_s": export32_s, "load_s": load_s,
            "launches": {"serve_cli_whole": cold["launches"],
                         "serve_warm_whole": warm["artifact"]["launches"],
                         "serve_warm_stream": n_stream,
                         "serve_warm_tta": tta["artifact"]["launches"]}}


def artifact_predict_phase(tmp: Path, arts: dict, pred_tiles: Path, bundle_mosaic: Path,
                           art32, live32, predict_cli: tuple) -> dict:
    """11c: ``python -m unet_tpu_torch predict --merge --device-merge`` with
    the float artifact on the prediction tiles (run during 11b:
    ``predict_cli`` is its seconds and output), its mosaic >= AGREE equal
    to the bundle's bf16 device merge; in this process in float32 (TF32
    off) the artifact's device merge against the bundle's, >= AGREE, with
    blend_count launched once a batch."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops.blend import blend_and_count
    from unet_tpu_torch.predict import predict as pp

    n_tiles = len(list(pred_tiles.glob("*.tif")))
    n_batches = -(-n_tiles // BATCH)
    secs = predict_cli[0]
    mosaic = pred_tiles.parent / f"art_2026_{arts['float'].stem}_prediction.tif"
    agree_cli = float((read_raster(mosaic).data[0] == read_raster(bundle_mosaic).data[0]).mean())
    maps, launches = {}, {}
    with tf32_off(), quiet_stdout(tmp / "art_predict.log"):
        for name, pred in (("artifact", art32), ("bundle", live32)):
            blend_and_count.launches = 0
            maps[name] = read_raster(pp.save_predictions(
                str(arts["float"]), str(pred_tiles), merge=True, AOI=f"art32{name}",
                year="2026", device_merge=True, predictor=pred)).data[0]
            launches[name] = blend_and_count.launches
            if launches[name] != n_batches:
                raise AssertionError(f"device merge through the {name}: "
                                     f"{launches[name]} launches for {n_batches}")
    agree32 = float((maps["artifact"] == maps["bundle"]).mean())
    print(f"predict CLI --merge --device-merge with the artifact: {n_tiles} tiles in "
          f"{secs:.2f} s with process start (beside 11b's float32 export and loads); "
          f"mosaic {100 * agree_cli:.4f}% equal to the bundle's (bf16); in process float32 "
          f"(TF32 off) {100 * agree32:.4f}%; "
          f"blend_count launches {launches['artifact']} ({n_batches} batches)")
    if min(agree_cli, agree32) < AGREE:
        raise AssertionError(f"artifact device merge agrees on {agree_cli} / {agree32}")
    return {"agree_cli": agree_cli, "agree32": agree32, "launches": launches["artifact"],
            "cli_s": secs}


@contextlib.contextmanager
def bn_variant(value: str):
    """``UNET_TPU_BN`` set to ``value`` ("" unsets it) inside the block."""
    old = os.environ.pop("UNET_TPU_BN", None)
    if value:
        os.environ["UNET_TPU_BN"] = value
    try:
        yield
    finally:
        os.environ.pop("UNET_TPU_BN", None)
        if old is not None:
            os.environ["UNET_TPU_BN"] = old


def variant_trainer(tiles: Path, tmp: Path, **cfg):
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(
        data_path=tiles, model_path=tmp / "variants", description="variants",
        codes=("background", "building", "vegetation"), arch="xresnet34",
        batch_size=BATCH, epochs=1, lr=1e-3, seed=SEED, **cfg))
    trainer.init_state()
    return trainer


def timed_steps(trainer, host: list, n: int = VARIANT_STEPS) -> tuple:
    """(median step ms after the first, launches of the last step as
    (bn_sum_sumsq, bn_bwd_sums, flip_scale), peak card memory bytes) of
    ``n`` train steps."""
    from unet_tpu_torch.ops import aug, bn

    counters = (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale)
    first = len(trainer.step_ms())
    torch.cuda.reset_peak_memory_stats()
    for i in range(n):
        for f in counters:
            f.launches = 0
        trainer.train_step(*host[i % len(host)])
    ms = trainer.step_ms()[first:]
    return (float(np.median(ms[1:])), tuple(f.launches for f in counters),
            torch.cuda.max_memory_allocated())


def slice_stats_check(dev) -> dict:
    """The flagship at float32 under ``slice:SLICE_K``, one training forward
    of a seeded 16 × 512² batch: every BatchNorm's running mean and
    variance equal 0.9·init + 0.1·(the statistics of its input's first
    SLICE_K samples, float64 here), within 1e-5·(1 + |value|); the
    distance to the whole batch's statistics printed beside."""
    from unet_tpu_torch.models import build_unet, init_weights
    from unet_tpu_torch.models.layers import SliceBatchNorm

    with bn_variant(f"slice:{SLICE_K}"):
        model = build_unet("xresnet34", n_out=N_OUT, c_in=3, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(SEED))
    model.to(dev).train()
    want, hooks = {}, []

    def hook(name):
        def fn(mod, inp):
            x = inp[0].double()
            stats = []
            for xs in (x[:SLICE_K], x):
                mean = xs.mean(dim=(0, 2, 3))
                var = torch.clamp((xs * xs).mean(dim=(0, 2, 3)) - mean * mean, min=0)
                stats.append((0.9 * mod.running_mean.double() + 0.1 * mean,
                              0.9 * mod.running_var.double() + 0.1 * var))
            want[name] = stats
        return fn

    sites = [(n, m) for n, m in model.named_modules() if isinstance(m, SliceBatchNorm)]
    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in sites]
    x = torch.rand((BATCH, 3, PATCH, PATCH), generator=torch.Generator(device=dev)
                   .manual_seed(SEED), device=dev)
    with torch.no_grad(), tf32_off():
        model(x, fold_logits=True)
    for h in hooks:
        h.remove()
    err = full = 0.0
    for name, m in sites:
        (rm, rv), (fm, fv) = want[name]
        for got, w, f in ((m.running_mean, rm, fm), (m.running_var, rv, fv)):
            err = max(err, float(((got.double() - w).abs() / (1 + w.abs())).max()))
            full = max(full, float(((got.double() - f).abs() / (1 + f.abs())).max()))
    print(f"slice:{SLICE_K} float32 running statistics at {len(sites)} sites: within "
          f"{err:.2e} (relative to 1 + |value|) of the first {SLICE_K} samples' "
          f"statistics; {full:.2e} from the whole batch's")
    if err > 1e-5 or len(sites) != 43:
        raise AssertionError(f"slice running statistics off by {err} at {len(sites)} sites")
    return {"err": err, "full_batch_dist": full, "sites": len(sites)}


def group_serve_check(dev, tmp: Path, trainer) -> dict:
    """The group trainer's bundle (its manifest records the variant) and
    its float32 artifact, served on the 4096² scene with UNET_TPU_BN unset,
    in float32 with TF32 off: class maps equal to the training build's in
    eval, probabilities within ART_PROB_ATOL on one batch. The same weights
    in a plain BatchNorm build, which is what a bundle without the record
    loads unset, printed beside."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.models import build_unet
    from unet_tpu_torch.predict import predict as pp
    from unet_tpu_torch.predict.artifact import ArtifactPredictor, export_artifact
    from unet_tpu_torch.tiling.windows import generate_windows

    bundle = trainer.export()
    model = trainer.model.eval()
    scene = tmp / "scene.tif"
    hwc = np.moveaxis(read_raster(scene).data, 0, 2)
    x = np.stack([hwc[w.indices()] for w in generate_windows(SCENE, SCENE, PATCH, 0.2)[:BATCH]])
    out = {}
    with tf32_off(), bn_variant(""), quiet_stdout(tmp / "group_serve.log"):
        model.dtype = torch.float32
        reference = pp.Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
        reference.model, reference.probs_fn = model, pp.make_probs_fn(model, False)
        want, _, _, _ = serve_map(reference, scene)
        want_probs = reference.predict_batch(x)
        loaded = pp.Predictor(str(bundle), batch_size=BATCH, device=dev, dtype=torch.float32)
        t0 = time.perf_counter()
        export_artifact(str(bundle), str(tmp / "group.uta"), dtype=torch.float32, device=dev)
        art = ArtifactPredictor(str(tmp / "group.uta"), batch_size=BATCH, device=dev)
        art_s = time.perf_counter() - t0
        for name, pred in (("bundle", loaded), ("artifact", art)):
            got, secs, _, _ = serve_map(pred, scene)
            out[name] = {"agree": float((got == want).mean()), "seconds": secs,
                         "prob_err": float(np.abs(pred.predict_batch(x) - want_probs).max())}
        plain = build_unet(model.arch, n_out=model.n_out, c_in=model.c_in,
                           dtype=torch.float32, bn_variant=None)
        plain.load_state_dict(loaded.model.state_dict())
        loaded.model, loaded.probs_fn = plain.to(dev).eval(), pp.make_probs_fn(plain, False)
        got, _, _, _ = serve_map(loaded, scene)
        out["plain_build_agree"] = float((got == want).mean())
    said = (tmp / "group_serve.log").read_text()
    print(f"group:32 bundle served with UNET_TPU_BN unset (float32, TF32 off, the {SCENE}² "
          f"scene): the loader said {said.strip().splitlines()[0]!r}; class maps equal to "
          f"the training build's in eval on {100 * out['bundle']['agree']:.4f}% (bundle), "
          f"{100 * out['artifact']['agree']:.4f}% (float32 artifact, exported and loaded in "
          f"{art_s:.1f} s); probabilities within {out['bundle']['prob_err']:.2e} / "
          f"{out['artifact']['prob_err']:.2e}; the same weights in a plain BatchNorm build "
          f"(what the loader built before bundles recorded the variant): "
          f"{100 * out['plain_build_agree']:.4f}%")
    if "group:32" not in said or min(out[k]["agree"] for k in ("bundle", "artifact")) < 1.0 \
            or max(out[k]["prob_err"] for k in ("bundle", "artifact")) > ART_PROB_ATOL:
        raise AssertionError(f"group bundle served unset: {out}")
    return out


def variant_phase(dev, tiles: Path, tmp: Path) -> dict:
    """11d: one flagship trainer (16 × 512², bf16) for each UNET_TPU_BN
    value of VARIANTS: step ms, launches a step (unset and slice 43 / 43 /
    1, group 0 / 0 / 1), a kernel step against a plain step (the bars of
    8), and the group trainer's bundle and artifact served with the
    variable unset (``group_serve_check``); then the slice variant's
    running statistics in float32. The unset variant's trainer is returned
    open (``out["trainer"]``) for 11e."""
    out = {}
    for value in VARIANTS:
        name = value or "unset"
        with bn_variant(value):
            trainer = variant_trainer(tiles, tmp)
        keep = False
        try:
            host = [b[:2] for b in trainer.train_loader]
            step_ms, launches, peak = timed_steps(trainer, host)
            want = (0, 0, 1) if value.startswith("group") else (43, 43, 1)
            print(f"UNET_TPU_BN={name}: step {step_ms:.2f} ms median of "
                  f"{VARIANT_STEPS - 1} after the first (CUDA events); launches a step "
                  f"bn_sum_sumsq/bn_bwd_sums/flip_scale {launches}; peak card memory "
                  f"{peak / 2**30:.2f} GiB")
            if launches != want:
                raise AssertionError(f"UNET_TPU_BN={name}: launches {launches}, want {want}")
            loss_rel, worst = step_check(trainer, host[0], f"UNET_TPU_BN={name}")
            out[name] = {"step_ms": step_ms, "launches": launches, "peak_bytes": peak,
                         "loss_rel": loss_rel, "grad_worst": worst}
            if value.startswith("group"):
                out[name]["served_unset"] = group_serve_check(dev, tmp, trainer)
            keep = not value
            if keep:
                out["trainer"], out["host"] = trainer, host
        finally:
            if not keep:
                trainer.close()
    out["slice_stats"] = slice_stats_check(dev)
    return out


def set_remat(model, on: bool) -> None:
    """Recompute the encoder's ResBlocks and the UnetBlocks in the backward."""
    model.remat = model.encoder.remat = on


def remat_phase(dev, tiles: Path, tmp: Path, bf16_trainer, host16: list) -> dict:
    """11e: from the same float32 weights and augmented batch (TF32 off),
    one ``loss_and_grads`` with remat off and one with it on: the running
    statistics bit-equal, the loss and every gradient bit-equal or within
    the bars of 8 (printed), bn_sum_sumsq launched 43 + the recomputed
    sites' count and bn_bwd_sums 43 times, peak card memory of both; then
    on ``bf16_trainer`` (11d's, closed here) steps with remat off and on:
    step ms and peak memory."""
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import bn

    trainer = variant_trainer(tiles, tmp, bf16=False)
    try:
        model = trainer.model
        recomputed = sum(isinstance(m, BatchNorm)
                         for blk in [model.encoder.get_submodule(n) for names in
                                     model.encoder.block_names for n in names]
                         + [model.get_submodule(f"up_{i}") for i in range(model.n_up)]
                         for m in blk.modules())
        host = [b[:2] for b in trainer.train_loader][0]
        x, y = trainer.augment(*trainer.to_device(*host), "train",
                               torch.Generator().manual_seed(5))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        runs = {}
        for on in (False, True):
            model.load_state_dict(state)
            set_remat(model, on)
            bn.bn_sum_sumsq.launches = bn.bn_bwd_sums.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with tf32_off():
                loss = trainer.loss_and_grads(x, y).item()
            runs[on] = {"loss": loss, "peak": torch.cuda.max_memory_allocated() - base,
                        "grads": [p.grad.clone() for p in model.parameters()],
                        "stats": {k: v.clone() for k, v in model.state_dict().items()
                                  if "running" in k or k.endswith("_u")},
                        "launches": (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)}
        off, on_ = runs[False], runs[True]
        grads_equal = all(torch.equal(a, b) for a, b in zip(off["grads"], on_["grads"]))
        stats_equal = all(torch.equal(off["stats"][k], on_["stats"][k]) for k in off["stats"])
        sq = sum(float(g.pow(2).sum()) for g in off["grads"])
        diff = sum(float((a - b).pow(2).sum()) for a, b in zip(off["grads"], on_["grads"]))
        loss_rel = abs(on_["loss"] - off["loss"]) / abs(off["loss"])
        moved = max(float((state[k].float() - off["stats"][k].float()).abs().max())
                    for k in off["stats"])
        print(f"remat float32 (TF32 off) vs no remat, same weights and batch: loss "
              f"{on_['loss']:.6f} vs {off['loss']:.6f} (rel {loss_rel:.2e}); gradients "
              f"{'bit-equal' if grads_equal else f'relative L2 {(diff / sq) ** 0.5:.2e}'}; "
              f"running statistics {'bit-equal' if stats_equal else 'differ'} after the "
              f"step (moved up to {moved:.3e} from before it); launches "
              f"bn_sum_sumsq/bn_bwd_sums {on_['launches']} with remat ({recomputed} "
              f"recomputed sites), {off['launches']} without; peak card memory above the "
              f"model's {on_['peak'] / 2**30:.2f} GiB with remat, {off['peak'] / 2**30:.2f} "
              f"GiB without")
        if not stats_equal or moved == 0.0:
            raise AssertionError("remat: the running statistics did not move exactly once")
        if loss_rel > 1e-3 or (diff / sq) ** 0.5 > GRAD_REL_L2:
            raise AssertionError("remat: loss or gradients off")
        if on_["launches"] != (43 + recomputed, 43) or off["launches"] != (43, 43):
            raise AssertionError(f"remat launches {on_['launches']}, no remat {off['launches']}")
    finally:
        trainer.close()
    try:
        bf16 = {}
        for on in (False, True):
            set_remat(bf16_trainer.model, on)
            bf16[on] = timed_steps(bf16_trainer, host16)
    finally:
        bf16_trainer.close()
    print(f"remat bf16 steps: {bf16[True][0]:.2f} ms with remat, {bf16[False][0]:.2f} ms "
          f"without (+{100 * (bf16[True][0] / bf16[False][0] - 1):.1f}%); peak card memory "
          f"{bf16[True][2] / 2**30:.2f} GiB with, {bf16[False][2] / 2**30:.2f} GiB without; "
          f"launches a step {bf16[True][1]} with, {bf16[False][1]} without")
    return {"grads_equal": grads_equal, "stats_equal": stats_equal, "loss_rel": loss_rel,
            "launches": on_["launches"], "recomputed": recomputed,
            "peak_f32": (on_["peak"], off["peak"]),
            "bf16_ms": (bf16[True][0], bf16[False][0]),
            "bf16_peak": (bf16[True][2], bf16[False][2]),
            "bf16_launches": bf16[True][1]}


def artifact_variants_phase(dev, tmp: Path, bundle: Path, pred_tiles: Path,
                            bundle_mosaic: Path, tiles: Path, transform, crs,
                            live_cli: dict) -> dict:
    """Phase 11: serving artifacts (a-c), the BatchNorm variants (d) and
    remat (e); offset_copy's launches in the phase (its count set to 0
    just before); the phase's seconds."""
    from unet_tpu_torch.ops import probe

    t0 = time.perf_counter()
    probe.offset_copy.launches = 0
    exported = artifact_export_phase(tmp, bundle)
    served = artifact_serve_phase(dev, tmp, bundle, exported["paths"], transform, crs,
                                  live_cli, pred_tiles)
    predicted = artifact_predict_phase(tmp, exported["paths"], pred_tiles, bundle_mosaic,
                                       served.pop("art32"), served.pop("live32"),
                                       served.pop("predict_cli"))
    variants = variant_phase(dev, tiles, tmp)
    remat = remat_phase(dev, tiles, tmp, variants.pop("trainer"), variants.pop("host"))
    secs = time.perf_counter() - t0
    print(f"phase 11: {secs:.1f} s; offset_copy launches {probe.offset_copy.launches}")
    return {"export": exported, "serve": served, "predict": predicted,
            "variants": variants, "remat": remat, "seconds": secs,
            "offset_copy_launches": probe.offset_copy.launches}


SPATIAL = 2               # phase 12: the spatial serve's and train step's ranks (one card, gloo)
SPATIAL_MEM = (1, 2, 4)   # the ranks of the 4096² window forwards whose peak memory is read
SPATIAL_AGREE = 0.99      # the spatial CLI's bf16 map against the unsharded CLI's (JAX's bar)
SPATIAL_PROB_ATOL = 1e-5  # the float32 spatial serve's probabilities against the unsharded


def tensor_digest(tensors: dict) -> str:
    """A hash of named tensors' bytes: ranks that agree bit for bit have
    the same."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def window_forward(pred, hwc: np.ndarray) -> dict:
    """One bf16 forward of the whole ``hwc`` scene as a single window
    (after a warm one): its ms (CUDA events) and this process's peak card
    memory over it (``max_memory_allocated`` after a reset), beside what
    was resident before (the model)."""
    x = hwc[None]
    pred.predict_batch_device(x)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(pred.device)
    resident = torch.cuda.memory_allocated(pred.device)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    pred.predict_batch_device(x)
    e.record()
    e.synchronize()
    return {"peak_bytes": torch.cuda.max_memory_allocated(pred.device),
            "resident_bytes": resident, "ms": s.elapsed_time(e)}


def spatial_rank(rank: int, n_ranks: int, port: int, tmp: Path, bundle: Path,
                 tiles: Path) -> None:
    """One of ``n_ranks`` ranks on the one card over gloo. Every rank: a
    4096² window's bf16 forward at spatial = ``n_ranks`` (peak memory);
    rank 0 of two first at spatial 1. With two ranks also (a) the 4096²
    scene served in float32 (TF32 off) at spatial 2, every class's
    probabilities; rank 0 serves it at spatial 1 first and compares, with
    its blend_count launches each way; (b) a float32 spatial train step
    of the flagship at BATCH × 512² (TF32 off; loss, launches, gradients;
    its kernels against their plain versions, held) and DDP_STEPS bf16
    steps (step ms, a digest of the weights). offset_copy's count, set to
    0 at the start, read at the end. Results to ``spatial<n>_rank<r>.pt``."""
    from dataclasses import replace

    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.ops import blend, probe
    from unet_tpu_torch.parallel import mesh
    from unet_tpu_torch.predict.predict import Predictor, predict_raster
    from unet_tpu_torch.train.loop import Trainer

    res = {}
    probe.offset_copy.launches = 0
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", n_ranks, rank, backend="gloo",
                              device="cuda")
        torch.cuda.set_device(mesh.rank_device("cuda"))
        scene = tmp / "scene.tif"
        hwc = np.ascontiguousarray(np.moveaxis(read_raster(scene).data, 0, 2))
        if rank == 0 and n_ranks == SPATIAL:
            res["mem1"] = window_forward(Predictor(str(bundle), batch_size=1), hwc)
        res["mem"] = window_forward(Predictor(str(bundle), batch_size=1, spatial=n_ranks),
                                    hwc)
        if n_ranks == SPATIAL:
            kw = dict(patch_size=PATCH, batch_size=BATCH, all_classes=True,
                      dtype=torch.float32)
            with tf32_off():
                if rank == 0:
                    one = Predictor(str(bundle), batch_size=BATCH, dtype=torch.float32)
                    blend.blend_and_count.launches = 0
                    p1 = predict_raster(str(bundle), str(scene), predictor=one, **kw)[0]
                    res["serve_one_launches"] = blend.blend_and_count.launches
                    del one
                pred = Predictor(str(bundle), batch_size=BATCH, dtype=torch.float32,
                                 spatial=SPATIAL)
                blend.blend_and_count.launches = 0
                t0 = time.perf_counter()
                p2 = predict_raster(str(bundle), str(scene), predictor=pred,
                                    spatial=SPATIAL, **kw)[0]
                res["serve_s"] = time.perf_counter() - t0
                res["serve_launches"] = blend.blend_and_count.launches
                if rank == 0:
                    margin = np.diff(np.sort(p1, axis=0)[-2:], axis=0)[0]
                    same = p2.argmax(0) == p1.argmax(0)
                    decided = margin >= 2 * SPATIAL_PROB_ATOL
                    res["serve"] = {"prob_err": float(np.abs(p2 - p1).max()),
                                    "classes_equal": float(same.mean()),
                                    "decided_equal": bool(same[decided].all()),
                                    "differ": int((~same).sum()),
                                    "max_margin_where_differ": float(margin[~same].max())
                                    if (~same).any() else None}
                del pred
                cfg = replace(ddp_config(tiles, tmp, False, BATCH), spatial=SPATIAL)
                t = Trainer(cfg)
                try:
                    t.init_state()
                    r = ddp_step(t)
                    r["vs_plain"] = step_check(t, r["host"], f"spatial rank {rank} of "
                                               f"{SPATIAL} (gloo, one card), float32")
                    r["digest"] = tensor_digest(r["grads"])
                    if rank:
                        del r["grads"]
                    res["fp32"] = r
                finally:
                    t.close()
            t = Trainer(replace(ddp_config(tiles, tmp, True, BATCH), spatial=SPATIAL))
            try:
                t.init_state()
                for _ in range(DDP_STEPS):
                    t.train_step(*res["fp32"]["host"])
                res["bf16"] = {"step_ms": t.step_ms(),
                               "digest": tensor_digest(t.model.state_dict())}
            finally:
                t.close()
            del res["fp32"]["host"]
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        res["offset_copy"] = probe.offset_copy.launches
        mesh.close_distributed()
        torch.save(res, tmp / f"spatial{n_ranks}_rank{rank}.pt")


def spawn_spatial_ranks(n: int, tmp: Path, bundle: Path, daemon: bool = False) -> list:
    """``n`` ``spatial_rank`` processes on a fresh loopback port, started
    (``daemon``: stopped with this process if it fails first)."""
    import multiprocessing

    from unet_tpu_torch.parallel import mesh

    ctx = multiprocessing.get_context("spawn")
    port = mesh.free_port()
    procs = [ctx.Process(target=spatial_rank, args=(r, n, port, tmp, bundle, tmp / "run_tiles"),
                         daemon=daemon)
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_spatial_ranks(procs: list, tmp: Path) -> list:
    """Each result of ``spawn_spatial_ranks``' processes once they end (a
    rank still running after 600 s is killed); a rank's error raises."""
    n = len(procs)
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    ranks = [torch.load(tmp / f"spatial{n}_rank{r}.pt", weights_only=False) for r in range(n)]
    for r, res in enumerate(ranks):
        if "error" in res:
            log(res["error"])
            raise RuntimeError(f"spatial rank {r} of {n} failed")
    return ranks


def spatial_phase(tmp: Path, bundle: Path, live_cli: dict, one_step: dict,
                  mem_procs: list) -> dict:
    """Phase 12: spatial partitioning (the tile height over ranks with halo
    exchanges) on the one card over gloo. (a) ``serve --spatial 2``
    through the CLI (UNET_TPU_TORCH_BACKEND=gloo: the command starts its
    two ranks) on the 4096² scene: bf16 map >= SPATIAL_AGREE equal to
    phase 4's unsharded CLI map, rank 0's blend_count launches equal to
    its; in process at float32 (TF32 off), probabilities within
    SPATIAL_PROB_ATOL of the unsharded serve's and classes equal wherever
    that bar decides them (top-two margin >= twice it), launches on rank 0
    equal. (b) The float32 spatial step of the flagship at BATCH
    × 512² against one process's (9d's, same tiles and draws; the bars of
    8), (43, 43, 1) launches a rank and step, the kernels against their
    plain versions on each rank, the ranks' weights bit-equal after
    DDP_STEPS bf16 steps, each rank's step ms (ranks sharing one card:
    not a scaling figure). (c) Each rank's peak card memory over a bf16
    forward of one 4096² window at spatial 1, 2 and 4. The CLI and then
    the two-rank spawn run alone on the card; ``mem_procs`` are the four
    ranks of (c) at spatial 4, which ``main`` starts beside 9c's quality
    gate (peak memory is each process's own; their forward ms are not a
    time figure). offset_copy must launch in no spawned rank."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    cli_out, cli_stats = tmp / "spatial_cli.tif", tmp / "spatial_cli.json"
    cli_s = run_cli(["serve", bundle, tmp / "scene.tif", cli_out, "--patch-size", PATCH,
                     "--batch-size", BATCH, "--spatial", SPATIAL, "--stats-json", cli_stats],
                    f"serve --spatial {SPATIAL}", True, {mesh.BACKEND_ENV: "gloo"})[0]
    ranks = {SPATIAL: join_spatial_ranks(spawn_spatial_ranks(SPATIAL, tmp, bundle), tmp),
             max(SPATIAL_MEM): join_spatial_ranks(mem_procs, tmp)}
    offset_copy = {f"spatial{n}_ranks": [res["offset_copy"] for res in rs]
                   for n, rs in ranks.items()}
    if any(c for counts in offset_copy.values() for c in counts):
        raise AssertionError(f"offset_copy launched on the spatial path: {offset_copy}")

    # (a) serve
    st = json.loads(cli_stats.read_text())
    cli_map, one_map = read_raster(cli_out).data[0], read_raster(tmp / "out.tif").data[0]
    agree = float((cli_map == one_map).mean())
    cli_launches = st["launches"]["blend_count"]
    print(f"serve --spatial {SPATIAL} through the CLI (two gloo ranks on one card, bf16, "
          f"alone on the card): {cli_s:.1f} s with process start ({st['seconds']:.2f} s of serve, "
          f"{st['tiles_per_s']:.1f} tiles/s); class map {100 * agree:.4f}% equal to phase 4's "
          f"unsharded CLI map; rank 0's blend_count launches {cli_launches} (unsharded "
          f"{live_cli['launches']['blend_count']}); rank 0's peak card memory "
          f"{st['peak_device_bytes'] / 1e9:.2f} GB (unsharded {live_cli['peak_device_bytes'] / 1e9:.2f})")
    if agree < SPATIAL_AGREE or cli_launches != live_cli["launches"]["blend_count"] \
            or st["spatial"] != SPATIAL:
        raise AssertionError(f"serve --spatial {SPATIAL}: agreement {agree}, launches "
                             f"{cli_launches}")
    r0, r1 = ranks[SPATIAL]
    sv = r0["serve"]
    print(f"spatial {SPATIAL} serve in process, float32, TF32 off, 4096² all-class mosaic: "
          f"max |Δp| {sv['prob_err']:.3e} against the unsharded serve, class maps "
          f"{100 * sv['classes_equal']:.5f}% equal ({sv['differ']} pixels differ, at top-two "
          f"margins up to {sv['max_margin_where_differ']}; every pixel whose margin is >= "
          f"{2 * SPATIAL_PROB_ATOL:g} equal: {sv['decided_equal']}); blend_count launches on "
          f"rank 0 {r0['serve_launches']} (unsharded {r0['serve_one_launches']}), rank 1 "
          f"{r1['serve_launches']}; {r0['serve_s']:.2f} s")
    if sv["prob_err"] > SPATIAL_PROB_ATOL or not sv["decided_equal"] \
            or r0["serve_launches"] != r0["serve_one_launches"] or r1["serve_launches"]:
        raise AssertionError(f"spatial serve: {sv}, launches {r0['serve_launches']} / "
                             f"{r0['serve_one_launches']} / {r1['serve_launches']}")

    # (b) train
    f0, f1 = r0["fp32"], r1["fp32"]
    if f0["loss"] != f1["loss"] or f0["digest"] != f1["digest"]:
        raise AssertionError("spatial step: the ranks' reduced gradients differ")
    for f in (f0, f1):
        if f["launches"] != (43, 43, 1):
            raise AssertionError(f"spatial step: a rank launched {f['launches']}")
    loss_rel = abs(f0["loss"] - one_step["loss"]) / abs(one_step["loss"])
    (worst, name), median = grad_errors(f0["grads"], one_step["grads"])
    print(f"spatial {SPATIAL} (gloo, one card) vs 1 process, float32 step on the same {BATCH} "
          f"tiles, TF32 off: loss {f0['loss']:.6f} vs {one_step['loss']:.6f} (rel "
          f"{loss_rel:.2e}); gradients per tensor median {median:.2e}, worst {worst:.2e} "
          f"({name}); launches per rank {f0['launches']}; kernels vs plain on each rank: "
          + "; ".join(f"rank {r} loss rel {lr:.2e}, worst gradient {w:.2e}"
                      for r, (lr, w) in enumerate((f0["vs_plain"], f1["vs_plain"]))))
    if loss_rel > 1e-3 or worst > GRAD_REL_L2:
        raise AssertionError("the spatial step disagrees with one process's")
    if r0["bf16"]["digest"] != r1["bf16"]["digest"]:
        raise AssertionError(f"after {DDP_STEPS} spatial steps the ranks' weights differ")
    step_ms = [float(np.median(r["bf16"]["step_ms"][1:])) for r in (r0, r1)]
    print(f"after {DDP_STEPS} bf16 spatial steps the ranks' weights and running statistics "
          f"are bit-equal; a rank's bf16 step of {BATCH} × {PATCH}² rows 1/{SPATIAL}: "
          + ", ".join(f"rank {r} {ms:.1f} ms" for r, ms in enumerate(step_ms))
          + " median after the first (ranks sharing one card over gloo: not a scaling "
          "figure)")

    # (c) memory
    mem = {1: [r0["mem1"]], SPATIAL: [r["mem"] for r in ranks[SPATIAL]],
           max(SPATIAL_MEM): [r["mem"] for r in ranks[max(SPATIAL_MEM)]]}
    for n in SPATIAL_MEM:
        print(f"one {SCENE}² window, bf16 forward at spatial {n}: peak card memory a rank "
              + ", ".join(f"{m['peak_bytes'] / 2**30:.3f}" for m in mem[n])
              + f" GiB (resident before: {mem[n][0]['resident_bytes'] / 2**30:.3f} GiB); "
              "forward ms a rank " + ", ".join(f"{m['ms']:.1f}" for m in mem[n])
              + (" (beside 9c's quality gate: not a time figure)" if n == max(SPATIAL_MEM)
                 else " (ranks sharing one card: not a scaling figure)"))
    secs = time.perf_counter() - t0
    print(f"phase 12: {secs:.1f} s")
    return {"seconds": secs, "cli_s": cli_s, "agree": agree, "serve": sv,
            "launches": {"blend_count": {"serve_cli_rank0": cli_launches,
                                         "serve_rank0": r0["serve_launches"],
                                         "serve_rank1": r1["serve_launches"],
                                         "serve_unsharded": r0["serve_one_launches"]},
                         **{k: {"rank_step": [f0["launches"][i], f1["launches"][i]]}
                            for i, k in enumerate(("bn_sum_sumsq", "bn_bwd_sums",
                                                   "flip_scale"))},
                         "offset_copy": offset_copy},
            "loss_rel": loss_rel, "grad_worst": worst, "step_ms": step_ms,
            "peak_bytes": {n: [m["peak_bytes"] for m in mem[n]] for n in SPATIAL_MEM}}


BENCH_ARGS = ("--tile", 256, "--batch-size", 4, "--steps", 4)  # phase 13's bench
BENCH_SECTIONS = ["train_parity_topology", "predict", "serving", "loader", "e2e_train",
                  "scaling", "kernels"]  # the stderr section lines, in JAX's order
BENCH_TARGET_S = 150  # phase 13's aim, printed beside its seconds


def bench_phase() -> dict:
    """13. ``python -m unet_tpu_torch bench`` at ``BENCH_ARGS`` through the
    CLI (each section in a child process of its own): exit 0; the headline
    JSON first and last on stdout; on stderr the seven section lines in
    JAX's order and the detail line, none with an error; both train
    sections 43 bn_sum_sumsq, 43 bn_bwd_sums and 1 flip_scale launches a
    step; the float artifact's class maps equal to the bundle's; blend_count
    launched by the streamed scene; the five kernels in the kernels
    section, each launched there. Returns the phase's seconds, the headline
    and each kernel's ``bench`` entry for the kernels' JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unet_tpu_torch", "bench",
                           *map(str, BENCH_ARGS)], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout + proc.stderr)
        raise RuntimeError(f"bench exited {proc.returncode}")
    out = proc.stdout.strip().splitlines()
    head = json.loads(out[0])
    if head.get("metric") != "train_tiles_per_sec_per_chip_512" or json.loads(out[-1]) != head:
        raise AssertionError(f"bench's headline is not its first and last line: {out}")
    lines = [json.loads(line) for line in proc.stderr.strip().splitlines()
             if line.startswith("{")]
    if [d.get("section") for d in lines[:-1]] != BENCH_SECTIONS or "train" not in lines[-1]:
        raise AssertionError(f"bench's stderr lines: {[d.get('section') for d in lines]}")
    detail = lines[-1]
    failed = [k for k, v in detail.items() if isinstance(v, dict) and "error" in v]
    if failed:
        raise AssertionError(f"bench sections failed: {failed}")
    want = {"bn_sum_sumsq": 43, "bn_bwd_sums": 43, "flip_scale": 1}
    for sec in ("train", "train_parity_topology"):
        if detail[sec]["launches_per_step"] != want:
            raise AssertionError(f"bench {sec} launches a step "
                                 f"{detail[sec]['launches_per_step']}, expected {want}")
    serving, kern = detail["serving"], detail["kernels"]
    if serving["artifact_matches_live"] is not True:
        raise AssertionError("bench serving: the float artifact's maps differ from the bundle's")
    if serving["launches"]["blend_count"] <= 0:
        raise AssertionError("bench serving: the streamed scene launched no blend_count")
    if set(kern["kernels"]) != set(LATE_UNIT) or min(kern["launches"].values()) <= 0:
        raise AssertionError(f"bench kernels: {sorted(kern['kernels'])}, launches "
                             f"{kern['launches']}")
    print(f"bench {' '.join(map(str, BENCH_ARGS))}: exit 0 in {secs:.1f} s (aim "
          f"{BENCH_TARGET_S} s); headline {head['value']} tiles/s/chip; step "
          f"{detail['train']['step_ms']} ms (parity {detail['train_parity_topology']['step_ms']})"
          f"; predict {detail['predict']['megapixels_per_sec']} Mpix/s; serve live "
          f"{serving['live_mpix_s']}, artifact {serving['artifact_mpix_s']}, int8 "
          f"{serving['artifact_int8_mpix_s']} Mpix/s; e2e "
          f"{detail['e2e_train']['e2e_tiles_per_sec']} tiles/s")
    print("bench section seconds (child process included): " + ", ".join(
        f"{k} {v:.1f}" for k, v in detail["section_seconds"].items()))
    for name in ("live", "artifact", "artifact_int8"):
        h, c, f = (serving[k][name]["median"] for k in (
            "host_ms_per_batch", "copy_host_ms_per_batch", "forward_ms"))
        print(f"bench serving {name}: host {h:.2f} ms a predict_batch_device call, pinned "
              f"copy {c:.2f} ms, forward {f:.2f} ms on the card (medians)")
    entries = {}
    for name, row in kern["kernels"].items():
        entries[name] = {
            "per": row["per"], "ms": row["ms"], "call_ms": row["call_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "share_of_bound": row["share_of_bound"], "max_abs_err": row["max_abs_err"],
            "launches": {"kernels": kern["launches"][name],
                         "train_step": detail["train"]["launches_per_step"].get(name),
                         "serving": serving["launches"][name],
                         "e2e_train": detail["e2e_train"]["launches"][name]}}
        lib = row["library_ms"]
        print(f"bench kernels {name} ({row['per']}): device {row['ms']['median'] * 1e3:.2f} us "
              f"[{row['ms']['min'] * 1e3:.2f}, {row['ms']['max'] * 1e3:.2f}], plain "
              f"{row['plain_ms'] * 1e3:.2f} us, library "
              + (f"{lib * 1e3:.2f} us" if lib is not None else "none")
              + f", bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
              f"{100 * row['share_of_bound']:.0f}% of its speed; max |kernel - plain| "
              f"{row['max_abs_err']:.3g} ({row['bar']})")
    return {"seconds": secs, "headline": head, "entries": entries}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from unet_tpu_torch import native
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.ops import _build
    from unet_tpu_torch.ops.blend import (DeviceMosaic, blend_and_count,
                                          blend_and_count_reference)
    from unet_tpu_torch.ops.probe import SOURCES as KERNELS
    from unet_tpu_torch.predict.merge import finalize_mosaic
    from unet_tpu_torch.predict.predict import Predictor, predict_raster, predict_raster_streamed
    from unet_tpu_torch.tiling.windows import generate_windows

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    log(f"-- phase 1 at {time.perf_counter() - t_start:.1f} s")
    # 1. the card
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    for mod in ("matplotlib", "pandas"):  # what the PNG plots and figures would need
        try:
            version = importlib.import_module(mod).__version__
            print(f"{mod}: imports ({version})")
        except ImportError as e:
            print(f"{mod}: does not import ({type(e).__name__}: {e})")

    log(f"-- phase 2 at {time.perf_counter() - t_start:.1f} s")
    # 2. build from source, cold even where a library is cached, one nvcc
    # process for each kernel source and one g++ for the native decoder,
    # all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        futs = [pool.submit(_build.build, k, force=True, verbose=True) for k in KERNELS]
        futs.append(pool.submit(native.build, force=True))
        for f in futs:
            f.result()
    if not native.available():
        raise RuntimeError(f"native decoder: {native.build_error()}")
    print(f"built {', '.join(KERNELS)} and the native decoder "
          f"({native.library_path().name}) in {time.perf_counter() - t0:.1f} s")

    log(f"-- phase 3 at {time.perf_counter() - t_start:.1f} s")
    # 3. kernel vs plain on random tiles at overlapping and edge offsets
    rng = np.random.default_rng(SEED)
    H3, W3, N3 = 1100, 1300, 16
    rows3 = np.concatenate([[0, H3 - PATCH, 0, H3 - PATCH],
                            rng.integers(0, H3 - PATCH + 1, N3 - 4)])
    cols3 = np.concatenate([[0, 0, W3 - PATCH, W3 - PATCH],
                            rng.integers(0, W3 - PATCH + 1, N3 - 4)])
    g = torch.Generator(device=dev).manual_seed(SEED)
    tiles3 = torch.rand((N3, N_OUT, PATCH, PATCH), generator=g, device=dev)
    m0 = torch.rand((N_OUT, H3, W3), generator=g, device=dev)
    c0 = torch.zeros((H3, W3), device=dev)
    mk, ck, mp, cp = m0.clone(), c0.clone(), m0.clone(), c0.clone()
    blend_and_count(mk, ck, tiles3, rows3, cols3)
    blend_and_count_reference(mp, cp, tiles3, rows3, cols3)
    torch.cuda.synchronize()
    equal3 = torch.equal(mk, mp) and torch.equal(ck, cp)
    if not equal3:
        raise AssertionError(
            f"blend_count differs from the plain version on random tiles: max "
            f"{(mk - mp).abs().max().item()}, count {(ck - cp).abs().max().item()}")
    k3 = cuda_ms(lambda: blend_and_count(mk, ck, tiles3, rows3, cols3))
    p3 = cuda_ms(lambda: blend_and_count_reference(mp, cp, tiles3, rows3, cols3))
    print(f"blend_count random {N3}x{N_OUT}x{PATCH}² on {H3}x{W3}: bit-equal; "
          f"kernel {k3 * 1e3:.1f} us, plain {p3 * 1e3:.1f} us")
    late: list = []  # cases whose device time is taken under torch.profiler, last
    oc = offset_copy_phase(dev, late)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        log(f"-- phase 4 at {time.perf_counter() - t_start:.1f} s")
        # 4. serve through the CLI in a subprocess; its launch counts start
        # at 0 in the new process and come back in the stats file
        t0 = time.perf_counter()
        bundle = make_bundle(tmp)
        transform, crs = make_scene(tmp / "scene.tif")
        log(f"bundle + scene in {time.perf_counter() - t0:.1f} s")
        stats = serve_cli(bundle, tmp / "scene.tif", tmp / "out.tif", tmp / "serve_stats.json")
        classes = check_class_map(tmp / "out.tif", transform, crs)
        launches = int(stats["launches"]["blend_count"])
        windows = generate_windows(SCENE, SCENE, PATCH, 0.2)
        n_batches = -(-len(windows) // BATCH)
        if launches != n_batches or stats["windows"] != len(windows):
            raise AssertionError(f"blend_count launched {launches} times for "
                                 f"{n_batches} batches")
        fwd = stats["forward_ms"]
        fwd_warm = float(np.median(fwd[1:]))
        print(f"serve: {stats['windows']} windows, {stats['batches']} batches in "
              f"{stats['seconds']:.2f} s = {stats['tiles_per_s']:.1f} tiles/s; forward "
              f"{fwd_warm:.1f} ms/batch of {BATCH} after one warm batch "
              f"(first {fwd[0]:.1f} ms); blend_count launches {launches}; "
              f"classes {classes}; peak host RSS of the CLI process {stats['peak_rss_gb']:.2f} "
              f"GB (sampled), peak card memory {stats['peak_device_bytes'] / 1e9:.2f} GB")

        log(f"-- phase 5 at {time.perf_counter() - t_start:.1f} s")
        # 5. kernel vs plain on the served scene's windows
        pred = Predictor(str(bundle), batch_size=BATCH, device=dev,
                         dtype=torch.bfloat16)
        t0 = time.perf_counter()
        hwc = np.moveaxis(read_raster(tmp / "scene.tif").data, 0, 2)
        host_s = {"read_scene": time.perf_counter() - t0}
        batches = []
        for s in range(0, len(windows), BATCH):
            chunk = windows[s:s + BATCH]
            x = np.stack([hwc[w.indices()] for w in chunk])
            if len(chunk) < BATCH:
                x = np.concatenate([x, np.repeat(x[-1:], BATCH - len(chunk), 0)])
            batches.append((pred.predict_batch_device(x)[:len(chunk)].contiguous(),
                            np.array([w.y for w in chunk]),
                            np.array([w.x for w in chunk])))
        mos_k = DeviceMosaic(SCENE, SCENE, N_OUT, device=dev)
        mos_p = DeviceMosaic(SCENE, SCENE, N_OUT, device=dev,
                             blend=blend_and_count_reference)
        for probs, r, q in batches:
            mos_k.add_batch(probs, r, q)
            mos_p.add_batch(probs, r, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk, ck5 = mos_k.finalize()
        host_s["mosaic_to_host"] = time.perf_counter() - t0
        sp, cp5 = mos_p.finalize()
        t0 = time.perf_counter()
        cmap, _ = finalize_mosaic(sk, ck5)
        host_s["finalize_argmax"] = time.perf_counter() - t0
        # what serve does now: finalize on the card, copy the class map
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cmap_card = mos_k.finish()[0].cpu().numpy()
        host_s["finalize_on_card_and_copy"] = time.perf_counter() - t0
        if not np.array_equal(cmap_card, cmap):
            raise AssertionError("the finalize on the card differs from finalize_mosaic")
        t0 = time.perf_counter()
        write_raster(tmp / "again.tif", cmap, transform=transform, crs=crs)
        host_s["write_class_map"] = time.perf_counter() - t0
        print("host phases of a serve (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in host_s.items()))
        # the main path again, in this process, with the model resident
        n_fwd = len(pred.forward_ms())
        blend_and_count.launches = 0
        t0 = time.perf_counter()
        predict_raster(str(bundle), str(tmp / "scene.tif"), str(tmp / "warm.tif"),
                       patch_size=PATCH, batch_size=BATCH, predictor=pred, device=dev)
        warm_s = time.perf_counter() - t0
        warm_launches = blend_and_count.launches
        if warm_launches != n_batches:
            raise AssertionError(f"warm serve launched blend_count {warm_launches} "
                                 f"times for {n_batches} batches")
        warm_fwd_s = sum(pred.forward_ms()[n_fwd:]) / 1e3
        warm_rec = pred.scenes[-1]
        print(f"warm serve (model resident, same scene): {warm_s:.2f} s = "
              f"{len(windows) / warm_s:.1f} tiles/s; forwards (CUDA events) "
              f"{warm_fwd_s:.3f} s = {100 * warm_fwd_s / warm_s:.1f}% of it; tier "
              f"{warm_rec['tier']}, finalize on the card {warm_rec['finalize_s'] * 1e3:.2f} ms "
              f"(device time, with the class map's copy); blend_count launches {warm_launches}")
        max_err = float(max(np.abs(sk - sp).max(), np.abs(ck5 - cp5).max()))
        if not (np.array_equal(sk, sp) and np.array_equal(ck5, cp5)):
            raise AssertionError(f"served-scene mosaics differ: max {max_err}")
        m_t = torch.zeros((N_OUT, SCENE, SCENE), device=dev)
        c_t = torch.zeros((SCENE, SCENE), device=dev)
        scene_k_ms = sum(cuda_ms(lambda: blend_and_count(m_t, c_t, p_, r_, q_))
                         for p_, r_, q_ in batches)
        probs, r, q = batches[0]
        k_ms = cuda_ms(lambda: blend_and_count(m_t, c_t, probs, r, q))
        p_ms = cuda_ms(lambda: blend_and_count_reference(m_t, c_t, probs, r, q))
        blend_fns = {"ms": lambda: blend_and_count(m_t, c_t, probs, r, q),
                     "plain_ms": lambda: blend_and_count_reference(m_t, c_t, probs, r, q),
                     "library_ms": library_index_add_fn(m_t, c_t, probs, r, q)}
        late.append({"kernel": "blend_count", "count": 1, "fns": blend_fns})
        lib_ms = cuda_ms(blend_fns["library_ms"])
        bound_ms, bound_by = blend_bound_ms(len(r), N_OUT, PATCH, PATCH, r, q)
        print(f"blend_count on the served scene ({len(r)}x{N_OUT}x{PATCH}² into "
              f"{SCENE}²): bit-equal over {len(batches)} batches; kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, index_add_ "
              f"{lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}); "
              f"all {len(batches)} batches {scene_k_ms * 1e3:.1f} us "
              f"(sum of per-batch medians)")
        del mos_k, mos_p, batches

        log(f"-- phase 5b at {time.perf_counter() - t_start:.1f} s")
        # 5b. the parity + self-attention model: serve cold and warm, bf16
        # against float32 at 512² and at a side not divisible by 4
        par_serve = parity_serve_phase(dev, tmp, transform, crs, hwc)

        log(f"-- phase 5c at {time.perf_counter() - t_start:.1f} s")
        # 5c. any-size serve: the three tiers at 4096² in float32, then a
        # BIG² scene through the CLI and in this process, banded and streamed
        tiers = tiers_phase(dev, tmp, bundle, hwc)
        big = big_serve_phase(dev, tmp, bundle, pred, np.moveaxis(hwc, 2, 0), transform, crs)

        log(f"-- phase 6 at {time.perf_counter() - t_start:.1f} s")
        # 6. the training kernels against their plain versions; the two
        # PixelShuffleICNR formulations timed against each other
        bn_t = bn_phase(dev, late)
        flip_t = flip_phase(dev, late)
        shuffle_t = shuffle_phase(dev)
        doctor_launches = doctor_phase()

        log(f"-- phase 7 at {time.perf_counter() - t_start:.1f} s")
        # 7. the native decoder on the tile set, then train through the
        # CLI and serve the exported bundle
        t0 = time.perf_counter()
        tiles = make_tiles(tmp / "tiles")
        log(f"tile set in {time.perf_counter() - t0:.1f} s")
        native_phase(tmp, tiles)
        trained = train_cli_phase(tmp, tiles)
        serve_inprocess(trained["bundle"], tmp / "scene.tif", tmp / "trained.tif")
        print(f"trained bundle served the {SCENE}² scene: classes "
              f"{check_class_map(tmp / 'trained.tif', transform, crs)}")

        log(f"-- phase 8 at {time.perf_counter() - t_start:.1f} s")
        # 8. train in this process
        inproc = train_inprocess_phase(tiles, tmp)
        trainer = inproc["trainer"]

        log(f"-- phase 8b at {time.perf_counter() - t_start:.1f} s")
        # 8b. the parity + self-attention model: train through the CLI and
        # serve its bundle, then in this process (step time, launches, a
        # kernel step against a plain step), and its attention and
        # full-resolution tail timed alone
        par_cli = parity_train_phase(dev, tmp, tiles, transform, crs)
        par_in = train_inprocess_phase(tiles, tmp, PARITY_STEPS, parity=True)
        par_trainer = par_in["trainer"]
        parts = parity_parts_ms(dev, par_trainer.model)
        print(f"parity parts alone (fwd+bwd, bf16, CUDA events): self-attention "
              f"{parts['attention_ms']:.2f} ms = {100 * parts['attention_ms'] / par_in['step_ms']:.1f}% "
              f"of the {par_in['step_ms']:.2f} ms step; full-resolution tail "
              f"{parts['tail_ms']:.2f} ms = {100 * parts['tail_ms'] / par_in['step_ms']:.1f}%")

        log(f"-- phase 8c at {time.perf_counter() - t_start:.1f} s")
        # 8c. the training surface: augmentation, grad_accum, regression with
        # the LR finder through the CLI and served, pretrained encoders,
        # existing_model, the other losses
        surface = train_surface_phase(dev, tmp, tiles, bundle, tmp / "scene.tif")

        log(f"-- phase 9 at {time.perf_counter() - t_start:.1f} s")
        # 9. bf16 vs float32 class maps on one batch of 16 tiles (TF32 off)
        pred32 = Predictor(str(bundle), batch_size=BATCH, device=dev,
                           dtype=torch.float32)
        agree, _ = class_agreement(pred, pred32,
                                   np.stack([hwc[w.indices()] for w in windows[:BATCH]]))
        print(f"bf16 vs float32 class maps on {BATCH} tiles: {agree * 100:.3f}% agree")
        if agree < 0.99:
            raise AssertionError(f"bf16 agrees with float32 on only {agree:.4f}")
        del pred32

        log(f"-- phase 9b at {time.perf_counter() - t_start:.1f} s")
        # 9b. the reference pipeline at full width: tile through the CLI,
        # train with the weighted focal loss, predict --merge through the
        # CLI on the host and on the card, against each other and serve
        tiled = tile_phase(tmp, transform, crs)
        piped = pipeline_train_phase(tmp, tiled["pipe"])
        focal = train_inprocess_phase(tiled["pipe"], tmp, PIPE_STEPS,
                                      loss_func="focal", class_weights="weighted")
        focal["trainer"].close()
        del focal["trainer"]
        predicted = pipeline_predict_phase(dev, tmp, piped["bundle"], tiled["pred"],
                                           tiled["pipe"], transform, crs)

        log(f"-- phase 9c at {time.perf_counter() - t_start:.1f} s")
        # 9c. the quality gate on the card; beside it (the gate times
        # nothing) phase 12c's four spatial ranks, which read peak memory
        mem_procs = spawn_spatial_ranks(max(SPATIAL_MEM), tmp, bundle, daemon=True)
        gate = gate_phase(tmp)

        log(f"-- phase 9d at {time.perf_counter() - t_start:.1f} s")
        # 9d. the reference's own entry point (run, api.main), resume after
        # a kill, two ranks on the one card, doctor's mesh check
        t9d = time.perf_counter()
        from unet_tpu_torch.ops import probe

        probe.offset_copy.launches = 0
        run9 = run_phase(tmp, tiled, transform, crs)
        ddp = ddp_phase(tmp, tmp / "run_tiles")
        mesh_d = mesh_doctor_phase()
        run9["offset_copy_launches"] = probe.offset_copy.launches
        print(f"phase 9d: {time.perf_counter() - t9d:.1f} s (run and resume "
              f"{run9['seconds']:.1f} s, two ranks {ddp['seconds']:.1f} s); doctor's mesh "
              f"check: {mesh_d['mesh']}")

        log(f"-- phase 11 at {time.perf_counter() - t_start:.1f} s")
        # 11. serving artifacts of 9b's trained bundle (export, serve,
        # predict --device-merge), the BatchNorm variants, remat
        art11 = artifact_variants_phase(dev, tmp, piped["bundle"], tiled["pred"],
                                        tmp / "pipeline_device.tif", tiles, transform, crs,
                                        stats)

        log(f"-- phase 12 at {time.perf_counter() - t_start:.1f} s")
        # 12. spatial partitioning on the one card over gloo: serve --spatial
        # 2 (CLI and in process), a spatial train step, per-rank memory
        sp12 = spatial_phase(tmp, bundle, stats, ddp.pop("one_fp32"), mem_procs)

        log(f"-- phase 13 at {time.perf_counter() - t_start:.1f} s")
        # 13. python -m unet_tpu_torch bench at a small size through the CLI
        torch.cuda.empty_cache()
        bench13 = bench_phase()

        log(f"-- phase 10 at {time.perf_counter() - t_start:.1f} s")
        # 10. under torch.profiler, after every kernel timing (the profiler
        # slows later launches): each kernel's device time, then the card's
        # busy time (union of its kernels and copies) against the wall time
        # of a warm serve, then of a few train steps, of each topology
        dev_t = device_times(late)
        alone = one_op_checks(late)
        stem = stem_site_device(bn_t["stem"])
        from unet_tpu_torch.ops.probe import empty_kernel

        empty_dev_ms = device_trace(lambda: empty_kernel(dev), "the empty kernel")["ms"]
        print(f"empty kernel device time (torch.profiler): {empty_dev_ms * 1e3:.2f} us")
        wrap_ms = wrapping_launch_ms(dev, big)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        profs, idle = {}, {}
        big_streamed = f"warm streamed serve {BIG}²"
        for what, run in (
                ("warm serve", lambda: predict_raster(
                    str(bundle), str(tmp / "scene.tif"), str(tmp / "warm.tif"),
                    patch_size=PATCH, batch_size=BATCH, predictor=pred, device=dev)),
                (f"{PROFILED_STEPS} train steps", lambda: [
                    trainer.train_step(*inproc["host"][i % len(inproc["host"])])
                    for i in range(PROFILED_STEPS)]),
                ("parity warm serve", lambda: predict_raster(
                    str(par_serve["bundle"]), str(tmp / "scene.tif"),
                    str(tmp / "parity_warm.tif"), patch_size=PATCH, batch_size=BATCH,
                    predictor=par_serve["pred"], device=dev)),
                (f"{PROFILED_STEPS} parity train steps", lambda: [
                    par_trainer.train_step(*par_in["host"][i % len(par_in["host"])])
                    for i in range(PROFILED_STEPS)]),
                ("device-merge predict", predicted["run"]),
                (big_streamed, lambda: predict_raster_streamed(
                    str(bundle), str(big["scene"]), str(tmp / "big_profiled.tif"),
                    patch_size=PATCH, batch_size=BATCH, predictor=pred, device=dev))):
            torch.cuda.synchronize()
            # the BIG² serve's 151 forwards: device activity only, which
            # is all the idle share reads, to keep the trace small
            with torch.profiler.profile(
                    activities=acts[1:] if what == big_streamed else acts) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
            profs[what] = prof
            busy_s, n_dev = device_busy_s(prof)
            if n_dev:
                idle[what] = 1 - busy_s / prof_s
                print(f"{what} under torch.profiler: {prof_s:.3f} s; card busy "
                      f"{busy_s:.3f} s over {n_dev} device events; idle share "
                      f"{100 * idle[what]:.1f}%")
            else:
                print(f"{what} under torch.profiler: no device events traced; "
                      "idle share not measured")
        for what in (f"{PROFILED_STEPS} train steps", f"{PROFILED_STEPS} parity train steps"):
            print(f"where the device time of {what} goes: "
                  + "; ".join(f"{ms:.2f} ms {n}x {k[:60]}"
                              for k, ms, n in top_kernels(profs[what])))
        par_prof = profs[f"{PROFILED_STEPS} parity train steps"]
        ops = op_device_ms(par_prof)
        busy_par = device_busy_s(par_prof)[0] * 1e3
        bn_ms = sum(ms for k, ms, _ in top_kernels(par_prof, n=10 ** 6)
                    if "partial_kernel" in k or "finish_kernel" in k)
        named = {"attention products (aten::bmm)":
                 sum(ops.get(k, (0.0, 0))[0] for k in ("aten::bmm",)),
                 "attention softmax (aten::_softmax, aten::_softmax_backward_data)":
                 sum(ops.get(k, (0.0, 0))[0]
                     for k in ("aten::_softmax", "aten::_softmax_backward_data")),
                 "bn_stats kernels (partial_kernel, finish_kernel)": bn_ms}
        print(f"parity train steps, device time by PyTorch op (self, torch.profiler, "
              f"{PROFILED_STEPS} steps, busy {busy_par:.2f} ms): "
              + "; ".join(f"{k} {ms:.2f} ms {n}x" for k, (ms, n) in
                          sorted(ops.items(), key=lambda t: -t[1][0])[:15]))
        print("parity train steps, named: " + "; ".join(
            f"{label} {ms:.2f} ms = "
            + (f"{100 * ms / busy_par:.1f}% of busy" if busy_par else "share not measured")
            for label, ms in named.items()))
        trainer.close()
        par_trainer.close()
        split = art11["serve"].pop("split_preds")
        if split is not None:  # ROADMAP §3 item 3: the card's time against the host's
            x_split = split.pop("x")
            art11["serve"]["split"] = forward_split(split, x_split)
            del split

    cuda_src = "unet_tpu_torch/ops/csrc/"
    train_launches = trained["launches"]
    par_launches = par_cli["launches"]
    parity = {  # each kernel's launches on the parity paths
        "blend_count": {"parity_serve_cli": par_serve["launches"],
                        "parity_serve_warm": par_serve["warm_launches"]},
        "bn_sum_sumsq": {"parity_train_cli": par_launches["bn_sum_sumsq"],
                         "parity_train_step": par_in["launches"][0],
                         "parity_step_ms": dev_t["bn_sum_sumsq"]["parity_ms"],
                         "parity_step_bound_ms": bn_t["parity_step"]["fwd_bound_ms"]},
        "bn_bwd_sums": {"parity_train_cli": par_launches["bn_bwd_sums"],
                        "parity_train_step": par_in["launches"][1],
                        "parity_step_ms": dev_t["bn_bwd_sums"]["parity_ms"],
                        "parity_step_bound_ms": bn_t["parity_step"]["bwd_bound_ms"]},
        "flip_scale": {"parity_train_cli": par_launches["flip_scale"],
                       "parity_train_step": par_in["launches"][2]},
        "offset_copy": {"parity_paths": 0},
    }
    pipeline = {  # each kernel's launches on the pipeline's paths, counts set to 0 before
        "blend_count": {"predict_device_merge": predicted["launches"],
                        "predict_host_merge": predicted["warm"]["host"]["launches"],
                        "idle_share_device_merge": idle.get("device-merge predict")},
        "bn_sum_sumsq": {"pipeline_train": piped["launches"]["bn_sum_sumsq"],
                         "parity_stem_site": stem["bn_sum_sumsq"]},
        "bn_bwd_sums": {"pipeline_train": piped["launches"]["bn_bwd_sums"],
                        "parity_stem_site": stem["bn_bwd_sums"]},
        "flip_scale": {"pipeline_train": piped["launches"]["flip_scale"]},
        "offset_copy": {"pipeline": 0},
    }
    any_size = {  # each kernel's launches on the any-size serve, counts set to 0 before
        "blend_count": {"tiers_4096": tiers["launches"],
                        f"serve_{BIG}": {k: r["launches"] for k, r in big["runs"].items()},
                        f"batches_{BIG}": len(big["batches"]),
                        "within_row_kernel_ms": wrap_ms["within a row"]["kernel_ms_per_batch"],
                        "wrapping_whole_kernel_ms":
                            wrap_ms["wrapping, whole"]["kernel_ms_per_batch"],
                        "wrapping_split_kernel_ms":
                            wrap_ms["wrapping, split"]["kernel_ms_per_batch"],
                        "idle_share_streamed": idle.get(big_streamed)},
        "bn_sum_sumsq": {"any_size": 0}, "bn_bwd_sums": {"any_size": 0},
        "flip_scale": {"any_size": 0}, "offset_copy": {"any_size": 0},
    }
    reg_cli = surface["regression_cli"]["launches"]
    train_surface = {  # each kernel's launches in phase 8c, counts set to 0 before each
        "blend_count": {"regression_serve": surface["regression_serve"]["launches"]},
        "bn_sum_sumsq": {**{f"grad_accum_{k}_step": r["launches"][0]
                            for k, r in surface["grad_accum"].items()},
                         "regression_lr_finder_cli": reg_cli["bn_sum_sumsq"]},
        "bn_bwd_sums": {**{f"grad_accum_{k}_step": r["launches"][1]
                           for k, r in surface["grad_accum"].items()},
                        "regression_lr_finder_cli": reg_cli["bn_bwd_sums"]},
        "flip_scale": {**{f"augment_{k.split(',')[0]}": r["launches"]
                          for k, r in surface["augment"].items()},
                       **{f"grad_accum_{k}_step": r["launches"][2]
                          for k, r in surface["grad_accum"].items()},
                       "regression_lr_finder_cli": reg_cli["flip_scale"]},
        "offset_copy": {"train_surface": 0},
    }
    run_resume_ddp = {  # each kernel's launches in phase 9d, counts set to 0 before each
        "blend_count": {"run_main": run9["main_launches"]["blend_count"]},
        **{k: {"run_main": run9["main_launches"][k],
               "ddp_rank_step": [lc[i] for lc in ddp["launches"]],
               "ddp_cli_rank0": ddp["cli_launches"][k],
               "ddp_rank_step_ms": ddp["step_ms"],
               "ddp_fp32_vs_plain": ddp["vs_plain"]}
           for i, k in enumerate(("bn_sum_sumsq", "bn_bwd_sums", "flip_scale"))},
        "offset_copy": {"run_resume_ddp": run9["offset_copy_launches"]},
    }
    var11, remat11 = art11["variants"], art11["remat"]
    artifact_variants = {  # each kernel's launches in phase 11, counts set to 0 before each
        "blend_count": {**art11["serve"]["launches"],
                        "predict_device_merge": art11["predict"]["launches"]},
        **{k: {**{f"bn_{v}_step": var11[v]["launches"][i]
                  for v in ("unset", "slice:8", "group:32")},
               "remat_step": (remat11["launches"] + (None,))[i],
               "remat_bf16_step": remat11["bf16_launches"][i]}
           for i, k in enumerate(("bn_sum_sumsq", "bn_bwd_sums", "flip_scale"))},
        "offset_copy": {"artifact_variants": art11["offset_copy_launches"]},
    }
    for kname in ("bn_sum_sumsq", "bn_bwd_sums", "flip_scale"):
        n = artifact_variants[kname]
        if min(n["bn_unset_step"], n["bn_slice:8_step"], n["remat_bf16_step"]) <= 0:
            raise AssertionError(f"{kname} was not launched on a path of phase 11: {n}")
    if min(artifact_variants["blend_count"].values()) <= 0:
        raise AssertionError(f"blend_count was not launched on an artifact path: "
                             f"{artifact_variants['blend_count']}")
    spatial = sp12["launches"]  # each kernel's launches in phase 12, counts set to 0 before each
    if min(spatial["blend_count"]["serve_cli_rank0"], spatial["blend_count"]["serve_rank0"],
           *(min(spatial[k]["rank_step"]) for k in ("bn_sum_sumsq", "bn_bwd_sums",
                                                     "flip_scale"))) <= 0:
        raise AssertionError(f"a kernel was not launched on a path of phase 12: {spatial}")
    for kname in ("bn_sum_sumsq", "bn_bwd_sums", "flip_scale"):
        n = run_resume_ddp[kname]
        if n["run_main"] <= 0 or min(n["ddp_rank_step"]) <= 0 or n["ddp_cli_rank0"] <= 0:
            raise AssertionError(f"{kname} was not launched on a path of phase 9d: {n}")
    for kname, n in pipeline.items():
        path_counts = [v for k, v in n.items() if k in ("predict_device_merge", "pipeline_train")]
        if any(c <= 0 for c in path_counts):
            raise AssertionError(f"{kname} was not launched on the pipeline: {n}")
    rows = [
        ("blend_count", "blend_count.cu", "unet_tpu/ops/blend.py:108", launches, max_err,
         k_ms, bound_ms, bound_by, {"equal": True, "kernel_us": k3 * 1e3, "plain_us": p3 * 1e3,
                                    "per": "batch of 16 tiles"}),
        ("bn_sum_sumsq", "bn_stats.cu", "unet_tpu/ops/pallas_bn.py:61",
         train_launches["bn_sum_sumsq"], bn_t["fwd_err"], bn_t["fwd_ms"],
         bn_t["fwd_bound_ms"], "bytes", {"per": "train step, 43 sites, bf16"}),
        ("bn_bwd_sums", "bn_stats.cu", "unet_tpu/ops/pallas_bn.py:95",
         train_launches["bn_bwd_sums"], bn_t["bwd_err"], bn_t["bwd_ms"],
         bn_t["bwd_bound_ms"], "bytes", {"per": "train step, 43 sites, bf16"}),
        ("flip_scale", "flip_scale.cu", "unet_tpu/ops/pallas_aug.py:126",
         train_launches["flip_scale"], flip_t["err"], flip_t["ms"], flip_t["bound_ms"],
         flip_t["bound_by"],
         {"per": "batch of 16 x 3 x 512² uint8 + masks", "call_host_ms": flip_t["host_ms"],
          "alone": alone[f"flip_scale {(BATCH, 3, PATCH, PATCH)}"]}),
        ("offset_copy", "offset_copy.cu", "unet_tpu/ops/probe.py:136",
         doctor_launches["offset_copy"], oc["err"], oc["ms"], oc["bound_ms"], "bytes",
         {"per": "call, (16, 128) source at offset 1, status through pinned host memory",
          "launch_bound_ms": oc["empty_ms"], "launch_bound_device_ms": empty_dev_ms,
          "alone": alone["offset_copy (16, 128) offset 1"]}),
    ]
    for row in rows:  # the redesigned kernels: their own interval and operations a call
        if row[0] in REDESIGNED:
            kernel_ms, _, ops = row[-1].pop("alone")
            row[-1].update(kernel_device_ms=kernel_ms, device_ops_per_call=ops,
                           redesigned=True)
    for row in rows:
        dev_t[row[0]].pop("parity_ms", None)
    kernels = {"kernels": [
        {"name": kname, "route": "cuda", "source": cuda_src + src, "replaces": replaces,
         "launches": n, "max_abs_err": err, **dev_t[kname], "bound_ms": b_ms,
         "bound_by": b_by, "call_ms": call_ms, **extra, "parity": parity[kname],
         "pipeline": pipeline[kname], "any_size": any_size[kname],
         "train_surface": train_surface[kname], "run_resume_ddp": run_resume_ddp[kname],
         "artifact_variants": artifact_variants[kname], "spatial": spatial[kname],
         "bench": bench13["entries"][kname]}
        for kname, src, replaces, n, err, call_ms, b_ms, b_by, extra in rows]}
    print("quality gate on the card: " + "; ".join(
        f"{r['topology']} s{r['seed']} {'bf16' if r['bf16'] else 'fp32'} dice "
        f"{r['dice']:.4f} mIoU {r['miou']:.4f}"
        + ("" if r["bf16"] else f" floors {'met' if r['floors_met'] else 'missed'}"
           + ("" if r["held"] else " (not held)"))
        for r in gate["runs"])
        + f" (cuDNN TF32 {gate['tf32']})")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
