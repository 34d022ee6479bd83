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
     merge, 0 on the host's);
     9c. the quality gate of tests/test_quality_parity.py on the card, field
     for field (the fixture's 384² scene, 128² tiles, xresnet18, weighted
     focal, float32, ``save_predictions(merge=True)``): parity at 14
     epochs and tpu_opt at 20 on seeds 0 and 1 held to the JAX floors,
     seed 2 measured against them, then tpu_opt seed 0 in bf16, printed;
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
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
SCENE = 4096
PATCH = 512
BATCH = 16
N_OUT = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# (C, H = W, count) of the 43 training BatchNorms of the xresnet34 tpu_opt
# U-Net at 512² tiles; each runs at batch 16
BN_SITES = [(64, 128, 7), (64, 256, 1), (128, 64, 10), (128, 128, 2),
            (256, 32, 14), (256, 128, 1), (512, 16, 8)]
# the same for the parity topology (three-conv stem at 32/32/64 channels)
BN_SITES_PARITY = [(32, 256, 2), (64, 256, 2), (64, 128, 7), (128, 64, 10),
                   (256, 32, 14), (512, 16, 8)]
BN_RAGGED = [(3, 3, 37, 41), (5, 1, 17, 13)]  # (N, C, H, W): C = 3 and 1, odd N·H·W
PARITY_STEM_SITE = (32, 256)  # (C, H = W): read alone for its device time
TRAIN_EPOCHS = 1      # CLI training: 1 epoch of 64 // 16 = 4 steps
TRAIN_STEPS = 6       # in-process timed steps
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
PARITY_STEPS = 6      # in-process timed parity steps
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


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm run."""
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


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


def blend_bound_ms(n, c, th, tw, rows, cols) -> tuple:
    """(bound_ms, bound_by): each tile read once, the covered mosaic and
    count read and written once; one add per tile element and count."""
    h = int(max(rows)) + th
    w = int(max(cols)) + tw
    cover = np.zeros((h, w), bool)
    for r, q in zip(rows, cols):
        cover[r:r + th, q:q + tw] = True
    covered = int(cover.sum())
    nbytes = n * c * th * tw * 4 + 2 * covered * (c + 1) * 4
    ops = n * (c + 1) * th * tw
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_busy_s(prof, since: float = float("-inf")) -> tuple:
    """(busy seconds, device events) of a ``torch.profiler`` trace: the
    union of the intervals in which the card ran a kernel, copy or set,
    counting only events that start at ``since`` (µs, the trace's clock)
    or later."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.start >= since)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6, len(spans)


def top_kernels(prof, n: int = 15) -> list:
    """(name, device ms, count) of the ``n`` device activities of a
    ``torch.profiler`` trace with the largest summed time."""
    tot: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = tot.get(e.name, (0.0, 0))
            tot[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, k + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()), key=lambda t: -t[1])[:n]


def library_index_add_fn(mosaic, count, tiles, rows, cols):
    """One ``index_add_`` computing the same sums and counts (atomics, so
    not bit-stable) — a yardstick only; the port never calls it."""
    c, h, w = mosaic.shape
    n, _, th, tw = tiles.shape
    dev = mosaic.device
    buf = torch.cat([mosaic, count[None]]).reshape(-1)
    src = torch.cat([tiles, torch.ones((n, 1, th, tw), device=dev)], 1).reshape(-1)
    ch = torch.arange(c + 1, device=dev).view(1, -1, 1, 1) * (h * w)
    yy = torch.arange(th, device=dev).view(1, 1, -1, 1)
    xx = torch.arange(tw, device=dev).view(1, 1, 1, -1)
    r = torch.as_tensor(np.asarray(rows), device=dev).view(-1, 1, 1, 1)
    q = torch.as_tensor(np.asarray(cols), device=dev).view(-1, 1, 1, 1)
    idx = (ch + (r + yy) * w + (q + xx)).reshape(-1)
    return lambda: buf.index_add_(0, idx, src)


def device_trace(fn, what: str, reps: int = 20, tries: int = 5) -> dict:
    """torch.profiler over ``reps`` calls of ``fn()``, after one warm call:
    ``{"ms": the union of the card's kernels, copies and sets per call
    (host overhead between launches left out), "ops": device operations
    per call, "by_name": {device event name: mean ms}}``.

    Each call launches at least one kernel, so a trace with fewer than
    ``reps`` device events is incomplete: among dozens of short profiler
    runs in a row, CUPTI now and then delivers none. Such a run is made
    again, up to ``tries`` times in all. Device events that start more
    than 1 ms before the run's first host event (a late delivery from an
    earlier run) are not counted."""
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        host0 = min((e.time_range.start for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CPU), default=0.0)
        busy_s, n_dev = device_busy_s(prof, since=host0 - 1e3)
        if n_dev >= reps:
            by_name: dict = {}
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and e.time_range.start >= host0 - 1e3):
                    by_name.setdefault(e.name, []).append(
                        (e.time_range.end - e.time_range.start) / 1e3)
            return {"ms": busy_s * 1e3 / reps, "ops": n_dev / reps,
                    "by_name": {k: float(np.mean(v)) for k, v in by_name.items()}}
        log(f"torch.profiler traced {n_dev} device events for {reps} calls of {what}; "
            "tracing again")
    raise RuntimeError(f"torch.profiler lost the trace of {reps} calls of {what} "
                       f"{tries} times")


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
            tr = device_trace(fn, f"{case['kernel']} {key} {case.get('what', '')}")
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
             "fwd_bound_ms": n_el * x.element_size() / HBM_BYTES_PER_S * 1e3,
             "bwd_bound_ms": 2 * n_el * x.element_size() / HBM_BYTES_PER_S * 1e3}
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
    img, msk = args["main"][:2]
    nbytes = img.numel() * (1 + 4) + msk.numel() * 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = img.numel() / F32_OPS_PER_S
    fns = {"ms": lambda: fused_flip_scale(*args["main"]),
           "plain_ms": lambda: fused_flip_scale_reference(*args["main"])}
    late.append({"kernel": "flip_scale", "count": 1, "fns": fns, "symbol": "flip_scale_kernel",
                 "group": 4, "bytes": nbytes, "what": f"flip_scale {shapes['main']}"})
    late.append({"kernel": "flip_scale", "count": 0, "symbol": "flip_scale_kernel", "group": 1,
                 "fns": {"ms": lambda: fused_flip_scale(*args["ragged"])},
                 "what": f"flip_scale {shapes['ragged']}"})
    out = {"ms": cuda_ms(fns["ms"]), "plain_ms": cuda_ms(fns["plain_ms"]),
           "host_ms": host_ms(fns["ms"]), "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "err": err}
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
    out["bound_ms"] = 2 * ROWS * COLS * 4 / HBM_BYTES_PER_S * 1e3
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


def run_cli(args: list, what: str, quiet: bool = False) -> tuple:
    """``python -m unet_tpu_torch <args>`` in a subprocess: (wall seconds,
    standard output); a nonzero exit raises. With ``quiet`` only the last
    lines of its output are logged."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unet_tpu_torch", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
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


def pipeline_predict_phase(dev, tmp: Path, bundle: Path, pred_tiles: Path, transform,
                           crs) -> dict:
    """``python -m unet_tpu_torch predict --merge`` of the prediction tiles,
    on the host and then with ``--device-merge`` (blend_count): both mosaics
    uint8, 4096², georeferenced like the scene, and >= 99.99% equal to each
    other; the device merge >= 99.99% equal to ``serve`` of the same bundle
    and scene in float32 (TF32 off; the bf16 agreement is printed); then in
    this process with the model resident: each mode's
    tiles/s and merge finalize seconds, and blend_count's launches on the
    device-merge path (counts set to 0 just before)."""
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
    return {"pred": pred, "run": lambda: run("device", "profiled"), "agree": agree,
            "agree_serve": agree_serve, "agree_serve_bf16": agree_serve16, "warm": warm,
            "cli_s": cli_s,
            "launches": warm["device"]["launches"]}


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
        trainer._step_times.clear()
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
                                           transform, crs)

        log(f"-- phase 9c at {time.perf_counter() - t_start:.1f} s")
        # 9c. the quality gate on the card
        gate = gate_phase(tmp)

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
         "train_surface": train_surface[kname]}
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
