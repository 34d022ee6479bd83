"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the blend_count CUDA kernel from the repo source (nvcc);
  3. kernel vs plain version on random tiles: bit-equal, and both timed;
  4. serve: a seeded random-init xresnet34 tpu_opt bundle (3 classes, 512²
     tiles, bf16) serves a 4096×4096×3 GeoTIFF through
     ``python -m unet_tpu_torch serve`` in a subprocess; the class map is
     checked and the run's kernel launch count read back;
  5. kernel vs plain version on the served scene's 100 windows, bit-equal,
     and the kernel timed at those shapes beside its bound and a library
     scatter-add; the host phases of a serve timed one by one, and the
     scene served again in this process with the model resident (warm
     tiles/s, the forwards' share of it, the kernel's launch count), and
     once more under torch.profiler for the card's idle share;
  6. bf16 vs float32 class maps on one batch of 16 tiles (>= 99% agree).
The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Needs no network; work files go to a
temporary directory inside the checkout and are removed at the end.
"""

from __future__ import annotations

import json
import os
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_scene(path: Path) -> tuple:
    """A 4096² 3-band uint8 scene with spatial structure: smooth fields,
    field-like blocks, a road grid and a little noise."""
    from unet_tpu_torch.geo import write_raster

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:SCENE, 0:SCENE].astype(np.float32)
    blocks = rng.uniform(40, 220, size=(3, 16, 16)).astype(np.float32)
    bands = []
    for c in range(3):
        field = np.kron(blocks[c], np.ones((SCENE // 16, SCENE // 16), np.float32))
        wave = 30 * np.sin(yy / (97.0 + 13 * c)) * np.cos(xx / (131.0 - 11 * c))
        road = ((yy % 700 < 24) | (xx % 900 < 24)) * (90.0 - 30 * c)
        bands.append(field + wave + road + rng.normal(0, 6, (SCENE, SCENE)))
    img = np.clip(np.stack(bands), 0, 255).astype(np.uint8)
    transform = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
    write_raster(path, img, transform=transform, crs="EPSG:25832")
    return transform, "EPSG:25832"


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


def device_busy_s(prof) -> tuple:
    """(busy seconds, device events) of a ``torch.profiler`` trace: the
    union of the intervals in which the card ran a kernel, copy or set."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6, len(spans)


def library_index_add_ms(mosaic, count, tiles, rows, cols) -> float:
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
    return cuda_ms(lambda: buf.index_add_(0, idx, src))


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.ops import _build
    from unet_tpu_torch.ops.blend import (DeviceMosaic, blend_and_count,
                                          blend_and_count_reference)
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

    # 2. build from source, cold even where a library is cached
    t0 = time.perf_counter()
    _build.build("blend_count", force=True, verbose=True)
    print(f"built blend_count in {time.perf_counter() - t0:.1f} s")

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
        out = read_raster(tmp / "out.tif")
        if out.data.dtype != np.uint8 or out.data.shape != (1, SCENE, SCENE):
            raise AssertionError(f"class map {out.data.dtype} {out.data.shape}")
        if int(out.data.max()) >= N_OUT:
            raise AssertionError(f"class {int(out.data.max())} >= {N_OUT}")
        if tuple(out.transform) != transform or out.crs != crs:
            raise AssertionError(f"georeference {out.transform} {out.crs}")
        launches = int(stats["launches"]["blend_count"])
        windows = generate_windows(SCENE, SCENE, PATCH, 0.2)
        n_batches = -(-len(windows) // BATCH)
        if launches != n_batches or stats["windows"] != len(windows):
            raise AssertionError(f"blend_count launched {launches} times for "
                                 f"{n_batches} batches")
        fwd = stats["forward_ms"]
        fwd_warm = float(np.median(fwd[1:]))
        classes = np.bincount(out.data.ravel(), minlength=N_OUT).tolist()
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
        lib_ms = library_index_add_ms(m_t, c_t, probs, r, q)
        bound_ms, bound_by = blend_bound_ms(len(r), N_OUT, PATCH, PATCH, r, q)
        print(f"blend_count on the served scene ({len(r)}x{N_OUT}x{PATCH}² into "
              f"{SCENE}²): bit-equal over {len(batches)} batches; kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, index_add_ "
              f"{lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}); "
              f"all {len(batches)} batches {scene_k_ms * 1e3:.1f} us "
              f"(sum of per-batch medians)")
        # the warm serve once more under torch.profiler: the card's busy
        # time (union of its kernels and copies) against the wall time.
        # After all kernel timings: the profiler slows later launches.
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            predict_raster(str(bundle), str(tmp / "scene.tif"), str(tmp / "warm.tif"),
                           patch_size=PATCH, batch_size=BATCH, predictor=pred,
                           device=dev)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
        busy_s, n_dev = device_busy_s(prof)
        if n_dev:
            print(f"warm serve under torch.profiler: {prof_s:.3f} s; card busy "
                  f"{busy_s:.3f} s over {n_dev} device events; idle share "
                  f"{100 * (1 - busy_s / prof_s):.1f}%")
        else:
            print("warm serve under torch.profiler: no device events traced; "
                  "idle share not measured")

        # 6. bf16 vs float32 class maps on one batch of 16 tiles (TF32 off)
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

    kernels = {"kernels": [{
        "name": "blend_count", "route": "cuda",
        "source": "unet_tpu_torch/ops/csrc/blend_count.cu",
        "replaces": "unet_tpu/ops/blend.py:108",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
        "equal": True, "kernel_us": k3 * 1e3, "plain_us": p3 * 1e3,
    }]}
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
