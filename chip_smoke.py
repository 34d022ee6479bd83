"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero), in this order:
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
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
     library scatter-add; the host phases of a serve timed one by one, and
     the scene served again in this process with the model resident (warm
     tiles/s, the forwards' share of it, the kernel's launch count);
  6. the training kernels vs their plain versions on random inputs, timed
     beside their bound and a PyTorch library call: bn_stats forward and
     backward at the 7 (C, H·W) shapes of the 43 training BatchNorms of the
     xresnet34 U-Net at batch 16 × 512², in bf16 and float32, plus two
     ragged shapes (within 1e-6 of the float64 sums, relative to Σ|x|,
     Σx², Σ|dy| and Σ|dy·x̂|; two launches bit-identical), and flip_scale on
     16 × 3 × 512² uint8 tiles with uint8 masks and mixed flags and on a
     ragged 16 × 3 × 37 × 301 batch (bit-equal), with the host time its
     wrapper takes a call;
     then ``doctor --kernels``, the path that runs offset_copy: in this
     process with every launch count set to 0 (each of the five kernels
     launched once, all checks ok), then ``python -m unet_tpu_torch doctor
     --kernels`` in a subprocess (exit 0, its report printed);
  7. the native decoder on the training tile set below: bit-equal to the
     Python codec on every tile and on a few tiles rewritten with LZW,
     deflate, PackBits and JPEG (JPEG segments decode natively in both, as
     in the JAX package; the pure-Python JPEG decoder within 2 levels), and
     the decode ms of a 16-tile batch each way; then train through ``python -m unet_tpu_torch train`` in a subprocess: the
     tpu_opt xresnet34 U-Net, random init from seed 0, 2 epochs over a
     seeded synthetic 512² tile set (64 train + 16 valid tiles, 3 classes
     that are a function of the image), batch 16, bf16; the history must
     be finite and every train-step kernel launched as many times as the
     steps say; then the exported bundle serves the 4096² scene of phase 4
     through ``python -m unet_tpu_torch serve``; the loader's decode path
     and first-batch times come back in the stats file;
  8. train in this process: step milliseconds and tiles/s, the per-step
     launch counts (43 / 43 / 1), and one step with the kernels against one
     with their plain versions from the same state, batch and flags (loss
     within 1e-3 relative, each parameter's gradient within 5e-2 relative
     L2 — bf16 convolutions — relative to at least 1e-2 of the RMS of all
     gradients);
  9. bf16 vs float32 class maps on one batch of 16 tiles (>= 99% agree);
  10. last, as the profiler slows later launches: a warm serve and a few
     train steps under torch.profiler for the card's idle share, then the
     device time of every kernel, its plain version and its library call
     at the shapes above (the union of the traced device intervals, host
     overhead left out; the CUDA-event times per call include it); from
     the same traces, one call of flip_scale (main and ragged shapes) and
     of offset_copy must be exactly one device operation, their kernel —
     flip_scale's main shape on the word path, the ragged one on the
     element path — and each kernel's own interval is printed beside the
     union, flip_scale's with its GB/s against the bytes bound.
The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Needs no network; work files go to a
temporary directory inside the checkout and are removed at the end.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import tempfile
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
BN_RAGGED = [(3, 3, 37, 41), (5, 1, 17, 13)]  # (N, C, H, W): C = 3 and 1, odd N·H·W
TRAIN_EPOCHS = 2      # CLI training: 2 epochs of 64 // 16 = 4 steps
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


def make_bundle(root: Path) -> Path:
    from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
    from unet_tpu_torch.train.checkpoint import export_bundle, to_flax_variables

    model = build_unet("xresnet34", n_out=N_OUT, c_in=3, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(SEED))
    manifest = {
        "ARCHITECTURE": "xresnet34", "n_out": N_OUT, "c_in": 3,
        "number_of_bands": 3, "patch_size": PATCH, "enable_regression": False,
        "CODES": ["background", "building", "vegetation"],
        "dtype_str": "uint8", "normalize": "unit", "self_attention": False,
        "tpu_opt": True, "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION,
    }
    export_bundle(root / "smoke", "smoke", to_flax_variables(model.state_dict()),
                  manifest)
    return root / "smoke"


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
    over the kernel's cases. A case with a ``symbol`` keeps the trace of
    its kernel calls in ``case["trace"]`` for ``one_op_checks``."""
    out: dict = {}
    for case in late:
        tot = out.setdefault(case["kernel"], {"ms": 0.0, "plain_ms": 0.0, "library_ms": None})
        for key, fn in case["fns"].items():
            tr = device_trace(fn, f"{case['kernel']} {key} {case.get('what', '')}")
            tot[key] = (tot[key] or 0.0) + case["count"] * tr["ms"]
            if key == "ms" and "symbol" in case:
                case["trace"] = tr
    for name, tot in out.items():
        lib = "not measured" if tot["library_ms"] is None else f"{tot['library_ms']:.4f}"
        print(f"{name} device time (torch.profiler) per {LATE_UNIT[name]}: kernel "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library {lib} ms")
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
    float64 sums at every training BatchNorm shape, bf16 and float32, plus
    ragged shapes; each call timed with CUDA events (bf16 sites weighted by
    their count give the per-step totals), and the bf16 sites queued in
    ``late`` for their device time."""
    from unet_tpu_torch.ops import bn

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    dims = (0, 2, 3)
    step = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "fwd_lib_ms", "bwd_ms",
                             "bwd_plain_ms", "bwd_lib_ms", "fwd_bound_ms",
                             "bwd_bound_ms")}
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases = [((BATCH, c, hw, hw), dt, count) for c, hw, count in BN_SITES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(shape, dt, 0) for shape in BN_RAGGED for dt in (torch.bfloat16, torch.float32)]
    for shape, dt, count in cases:
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
        if dt != torch.bfloat16 or not count:
            continue
        w = torch.ones(c, device=dev)
        fwd = {"ms": lambda x=x: bn.bn_sum_sumsq(x),
               "plain_ms": lambda x=x: bn.bn_sum_sumsq_reference(x),
               "library_ms": lambda x=x: torch.ops.aten.batch_norm_stats(x, 1e-5)}
        bwd = {"ms": lambda a=(dy, x, mean, inv): bn.bn_bwd_sums(*a),
               "plain_ms": lambda a=(dy, x, mean, inv): bn.bn_bwd_sums_reference(*a),
               "library_ms": lambda a=(dy, x, mean, inv, w): (
                   torch.ops.aten.batch_norm_backward_reduce(*a, True, True, True))}
        late += [{"kernel": "bn_sum_sumsq", "count": count, "fns": fwd},
                 {"kernel": "bn_bwd_sums", "count": count, "fns": bwd}]
        t = {"fwd_ms": cuda_ms(fwd["ms"]), "fwd_plain_ms": cuda_ms(fwd["plain_ms"]),
             "fwd_lib_ms": cuda_ms(fwd["library_ms"]), "bwd_ms": cuda_ms(bwd["ms"]),
             "bwd_plain_ms": cuda_ms(bwd["plain_ms"]), "bwd_lib_ms": cuda_ms(bwd["library_ms"]),
             "fwd_bound_ms": n_el * x.element_size() / HBM_BYTES_PER_S * 1e3,
             "bwd_bound_ms": 2 * n_el * x.element_size() / HBM_BYTES_PER_S * 1e3}
        for k, v in t.items():
            step[k] += count * v
        print(f"bn_stats {shape} bf16 x{count}: fwd {t['fwd_ms'] * 1e3:.1f} us (plain "
              f"{t['fwd_plain_ms'] * 1e3:.1f}, batch_norm_stats {t['fwd_lib_ms'] * 1e3:.1f}, "
              f"bound {t['fwd_bound_ms'] * 1e3:.1f}); bwd {t['bwd_ms'] * 1e3:.1f} us (plain "
              f"{t['bwd_plain_ms'] * 1e3:.1f}, batch_norm_backward_reduce "
              f"{t['bwd_lib_ms'] * 1e3:.1f}, bound {t['bwd_bound_ms'] * 1e3:.1f})")
    print(f"bn_stats: {len(cases)} cases within 1e-6 of float64 and bit-stable; per train "
          f"step (43 sites, bf16, CUDA events per call): fwd {step['fwd_ms']:.3f} ms, plain "
          f"{step['fwd_plain_ms']:.3f}, library {step['fwd_lib_ms']:.3f}, bound "
          f"{step['fwd_bound_ms']:.3f}; bwd {step['bwd_ms']:.3f} ms, plain "
          f"{step['bwd_plain_ms']:.3f}, library {step['bwd_lib_ms']:.3f}, bound "
          f"{step['bwd_bound_ms']:.3f}")
    return {**step, "fwd_err": worst["fwd"], "bwd_err": worst["bwd"]}


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


def train_cli_phase(tmp: Path, tiles: Path) -> dict:
    """``python -m unet_tpu_torch train`` in a subprocess (launch counts
    start at 0 there and come back in the stats file)."""
    stats_path = tmp / "train_stats.json"
    cmd = [sys.executable, "-m", "unet_tpu_torch", "train", str(tiles),
           "--model-path", str(tmp / "models"), "--description", "trained",
           "--codes", "background", "building", "vegetation", "--arch", "xresnet34",
           "--batch-size", str(BATCH), "--epochs", str(TRAIN_EPOCHS), "--lr", "1e-3",
           "--seed", str(SEED), "--stats-json", str(stats_path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
    log(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"train exited {proc.returncode}")
    wall = time.perf_counter() - t0
    st = json.loads(stats_path.read_text())
    steps = TRAIN_EPOCHS * (64 // BATCH)
    evals = TRAIN_EPOCHS * -(-16 // BATCH)
    want = {"bn_sum_sumsq": 43 * steps, "bn_bwd_sums": 43 * steps,
            "flip_scale": steps + evals}
    if st["steps"] != steps or st["launches"] != want:
        raise AssertionError(f"train ran {st['steps']} steps, launches {st['launches']}, "
                             f"expected {steps} and {want}")
    for row in st["history"]:
        if not all(np.isfinite([row["train_loss"], row["valid_loss"], row["dice_multi"]])):
            raise AssertionError(f"non-finite history row {row}")
    bundle = tmp / "models" / "trained"
    for name in ("trained.json", "trained.msgpack", "best-model.msgpack",
                 "trained_history.csv"):
        if not (bundle / name).is_file():
            raise AssertionError(f"bundle lacks {name}")
    ms = st["step_ms"]
    print(f"train CLI: {steps} steps of {BATCH}x{PATCH}² in {st['seconds']:.2f} s of fit "
          f"({wall:.1f} s with process start); step {float(np.median(ms[1:])):.1f} ms "
          f"median after the first ({ms[0]:.1f} ms); history "
          + "; ".join(f"epoch {r['epoch']}: train {r['train_loss']:.4f} valid "
                      f"{r['valid_loss']:.4f} dice {r['dice_multi']:.4f}"
                      for r in st["history"])
          + f"; launches {st['launches']}")
    loader = st["loader"]
    if loader["path"] not in ("native", "python"):
        raise AssertionError(f"train loader reports path {loader['path']}")
    print(f"train CLI loader: decode path {loader['path']}; first batch "
          + ", ".join(f"{k} {'not timed' if v is None else f'{v:.1f} ms'}"
                      for k, v in loader["first_batch_ms"].items()))
    return {"bundle": bundle, "launches": st["launches"], "stats": st}


def train_inprocess_phase(tiles: Path, tmp: Path) -> dict:
    """Step time, per-step launch counts, and a kernel step against a plain
    step from the same state, batch and flags."""
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import aug, bn
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(
        data_path=tiles, model_path=tmp / "inproc", description="inproc",
        codes=("background", "building", "vegetation"), arch="xresnet34",
        batch_size=BATCH, epochs=1, lr=1e-3, seed=SEED))
    try:
        trainer.init_state()
        host = [b[:2] for b in trainer.train_loader]
        counters = (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale)
        per_step = []
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
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
        print(f"train in-process: {TRAIN_STEPS} steps, {step_ms:.2f} ms per step median "
              f"after the first ({ms[0]:.1f} ms) = {BATCH * 1e3 / step_ms:.1f} tiles/s "
              f"(CUDA events); wall {wall:.2f} s; launches per step "
              f"bn_sum_sumsq/bn_bwd_sums/flip_scale {per_step[-1]}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

        # the kernels against their plain versions, one step from one state
        state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        dev_batch = trainer.to_device(*host[0])
        x, y = trainer.augment(*dev_batch, "train", torch.Generator().manual_seed(5))
        xp, yp = trainer.augment(*dev_batch, "train", torch.Generator().manual_seed(5),
                                 flip_scale=aug.fused_flip_scale_reference)
        if not (torch.equal(x, xp) and torch.equal(y, yp)):
            raise AssertionError("flip_scale batch differs from its plain version")
        loss_k = trainer.loss_and_grads(x, y).item()
        grads_k = [p.grad.clone() for p in trainer.model.parameters()]
        trainer.model.load_state_dict(state)
        bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
        for m in bns:
            m.reductions = bn.PLAIN_REDUCTIONS
        before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
        loss_p = trainer.loss_and_grads(xp, yp).item()
        if (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches) != before:
            raise AssertionError("the plain step launched a bn_stats kernel")
        for m in bns:
            m.reductions = bn.KERNEL_REDUCTIONS
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
        print(f"kernel step vs plain step: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
              f"{loss_rel:.2e}); all gradients' relative L2 error {(diff / sq) ** 0.5:.2e}; "
              f"per tensor median {float(np.median([r for r, _ in rel])):.2e}, worst "
              f"{worst[0]:.2e} ({worst[1]}) over {len(rel)} tensors (floor "
              f"{GRAD_FLOOR} of the RMS)")
        if loss_rel > 1e-3 or worst[0] > GRAD_REL_L2:
            raise AssertionError("kernel step and plain step disagree")
        trainer.model.load_state_dict(state)
        return {"trainer": trainer, "host": host, "step_ms": step_ms}
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
    from unet_tpu_torch.predict.predict import Predictor, predict_raster
    from unet_tpu_torch.tiling.windows import generate_windows

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # 1. the card
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

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
        # 4. serve through the CLI in a subprocess; its launch counts start
        # at 0 in the new process and come back in the stats file
        t0 = time.perf_counter()
        bundle = make_bundle(tmp)
        transform, crs = make_scene(tmp / "scene.tif")
        log(f"bundle + scene in {time.perf_counter() - t0:.1f} s")
        stats_path = tmp / "serve_stats.json"
        cmd = [sys.executable, "-m", "unet_tpu_torch", "serve", str(bundle),
               str(tmp / "scene.tif"), str(tmp / "out.tif"),
               "--patch-size", str(PATCH), "--batch-size", str(BATCH),
               "--stats-json", str(stats_path)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900, env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
        log(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"serve exited {proc.returncode}")
        stats = json.loads(stats_path.read_text())
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
              f"classes {classes}")

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
        print(f"warm serve (model resident, same scene): {warm_s:.2f} s = "
              f"{len(windows) / warm_s:.1f} tiles/s; forwards (CUDA events) "
              f"{warm_fwd_s:.3f} s = {100 * warm_fwd_s / warm_s:.1f}% of it; "
              f"blend_count launches {warm_launches}")
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

        # 6. the training kernels against their plain versions
        bn_t = bn_phase(dev, late)
        flip_t = flip_phase(dev, late)
        doctor_launches = doctor_phase()

        # 7. the native decoder on the tile set, then train through the
        # CLI and serve the exported bundle
        t0 = time.perf_counter()
        tiles = make_tiles(tmp / "tiles")
        log(f"tile set in {time.perf_counter() - t0:.1f} s")
        native_phase(tmp, tiles)
        trained = train_cli_phase(tmp, tiles)
        cmd = [sys.executable, "-m", "unet_tpu_torch", "serve", str(trained["bundle"]),
               str(tmp / "scene.tif"), str(tmp / "trained.tif"),
               "--patch-size", str(PATCH), "--batch-size", str(BATCH)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900, env={**os.environ, "UNET_TPU_TRACEBACK": "1"})
        log(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"serve of the trained bundle exited {proc.returncode}")
        print(f"trained bundle served the {SCENE}² scene: classes "
              f"{check_class_map(tmp / 'trained.tif', transform, crs)}")

        # 8. train in this process
        inproc = train_inprocess_phase(tiles, tmp)
        trainer = inproc["trainer"]

        # 9. bf16 vs float32 class maps on one batch of 16 tiles (TF32 off)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        pred32 = Predictor(str(bundle), batch_size=BATCH, device=dev,
                           dtype=torch.float32)
        x = np.stack([hwc[w.indices()] for w in windows[:BATCH]])
        cls16 = pred.predict_batch_device(x, argmax_u8=True)
        cls32 = pred32.predict_batch_device(x, argmax_u8=True)
        agree = (cls16 == cls32).float().mean().item()
        print(f"bf16 vs float32 class maps on {BATCH} tiles: {agree * 100:.3f}% agree")
        if agree < 0.99:
            raise AssertionError(f"bf16 agrees with float32 on only {agree:.4f}")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del pred32

        # 10. under torch.profiler, after every kernel timing (the profiler
        # slows later launches): the card's busy time (union of its kernels
        # and copies) against the wall time of a warm serve, then of a few
        # train steps
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for what, run in (
                ("warm serve", lambda: predict_raster(
                    str(bundle), str(tmp / "scene.tif"), str(tmp / "warm.tif"),
                    patch_size=PATCH, batch_size=BATCH, predictor=pred, device=dev)),
                (f"{PROFILED_STEPS} train steps", lambda: [
                    trainer.train_step(*inproc["host"][i % len(inproc["host"])])
                    for i in range(PROFILED_STEPS)])):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
            busy_s, n_dev = device_busy_s(prof)
            if n_dev:
                print(f"{what} under torch.profiler: {prof_s:.3f} s; card busy "
                      f"{busy_s:.3f} s over {n_dev} device events; idle share "
                      f"{100 * (1 - busy_s / prof_s):.1f}%")
            else:
                print(f"{what} under torch.profiler: no device events traced; "
                      "idle share not measured")
        print(f"where the device time of {PROFILED_STEPS} train steps goes: "
              + "; ".join(f"{ms:.2f} ms {n}x {k[:60]}" for k, ms, n in top_kernels(prof)))
        trainer.close()
        dev_t = device_times(late)
        alone = one_op_checks(late)
        from unet_tpu_torch.ops.probe import empty_kernel

        empty_dev_ms = device_trace(lambda: empty_kernel(dev), "the empty kernel")["ms"]
        print(f"empty kernel device time (torch.profiler): {empty_dev_ms * 1e3:.2f} us")

    cuda_src = "unet_tpu_torch/ops/csrc/"
    train_launches = trained["launches"]
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
    kernels = {"kernels": [
        {"name": kname, "route": "cuda", "source": cuda_src + src, "replaces": replaces,
         "launches": n, "max_abs_err": err, **dev_t[kname], "bound_ms": b_ms,
         "bound_by": b_by, "call_ms": call_ms, **extra}
        for kname, src, replaces, n, err, call_ms, b_ms, b_by, extra in rows]}
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
