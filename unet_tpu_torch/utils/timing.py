"""Timing on the card and the bounds of the port's CUDA kernels.

Shared by ``bench`` and ``chip_smoke.py``:

* the H100's published rates (``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``) and
  ``bound``: the least time the card could take for a function, the larger
  of its bytes over the memory rate and its operations over the float32
  rate;
* the main-path shapes of the kernels: ``BN_SITES`` (the 43 training
  BatchNorms of the flagship) and the bytes and operations of each
  kernel's call (``bn_work``, ``flip_work``, ``blend_work``,
  ``offset_copy_work``);
* ``cuda_times`` / ``cuda_ms`` (CUDA events around each call, host
  included), ``device_trace`` (the card's busy time a call under
  ``torch.profiler``, host overhead left out) and ``spread``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# (C, H = W, count) of the 43 training BatchNorms of the xresnet34 tpu_opt
# U-Net at BN_TILE² tiles; each runs at the train batch
BN_SITES = [(64, 128, 7), (64, 256, 1), (128, 64, 10), (128, 128, 2),
            (256, 32, 14), (256, 128, 1), (512, 16, 8)]
BN_TILE = 512


def bn_sites(tile: int = BN_TILE) -> List[Tuple[int, int, int]]:
    """``BN_SITES`` at ``tile``² tiles: every side scales with the tile
    (``tile`` a multiple of 32, so the deepest site keeps whole rows)."""
    if tile % 32:
        raise ValueError(f"tile {tile} is not a multiple of 32")
    return [(c, h * tile // BN_TILE, count) for c, h, count in BN_SITES]


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(milliseconds, "bytes" or "operations"): the larger of ``nbytes``
    over the memory rate and ``ops`` over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bn_work(shape: Sequence[int], element_size: int, backward: bool) -> Tuple[int, int]:
    """(bytes, operations) of one ``bn_stats`` call on an NCHW ``shape``:
    x (and dy in the backward) read once; a sum and a square-sum (the
    backward: the normalize, a product and two sums) a value. The (2, C)
    output is left out."""
    n = int(np.prod(shape))
    return (2 if backward else 1) * n * element_size, (5 if backward else 3) * n


def flip_work(b: int, c: int, h: int, w: int, image_size: int = 1,
              mask_size: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of one ``flip_scale`` call: images read in their
    dtype and written as float32, masks read and written, one multiply an
    image value."""
    n = b * c * h * w
    return n * (image_size + 4) + 2 * b * h * w * mask_size, n


def blend_work(n: int, c: int, th: int, tw: int, rows, cols) -> Tuple[int, int]:
    """(bytes, operations) of one ``blend_count`` call: each tile read
    once, the covered mosaic and count read and written once; one add per
    tile value and count."""
    h = int(max(rows)) + th
    w = int(max(cols)) + tw
    cover = np.zeros((h, w), bool)
    for r, q in zip(rows, cols):
        cover[r:r + th, q:q + tw] = True
    covered = int(cover.sum())
    return n * c * th * tw * 4 + 2 * covered * (c + 1) * 4, n * (c + 1) * th * tw


def blend_bound_ms(n, c, th, tw, rows, cols) -> Tuple[float, str]:
    """``bound`` of one ``blend_count`` call (``blend_work``)."""
    return bound(*blend_work(n, c, th, tw, rows, cols))


def offset_copy_work(rows: int = 8, cols: int = 128) -> Tuple[int, int]:
    """(bytes, operations) of one ``offset_copy`` call: the selected rows
    read once and written once."""
    return 2 * rows * cols * 4, 0


def spread(values: Sequence[float]) -> Dict[str, float]:
    """{"median", "min", "max", "n"} of ``values``."""
    v = np.asarray(list(values), np.float64)
    return {"median": float(np.median(v)), "min": float(v.min()), "max": float(v.max()),
            "n": int(v.size)}


def cuda_times(fn: Callable, reps: int = 10) -> List[float]:
    """Milliseconds of each of ``reps`` runs of ``fn()`` (CUDA events on
    the current stream, each run waited for), after one warm run."""
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


def cuda_ms(fn: Callable, reps: int = 10) -> float:
    """Median of ``cuda_times``."""
    return float(np.median(cuda_times(fn, reps)))


def device_busy_s(prof, since: float = float("-inf")) -> Tuple[float, int]:
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


def device_trace(fn: Callable, what: str, reps: int = 20, tries: int = 5) -> dict:
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
        print(f"torch.profiler traced {n_dev} device events for {reps} calls of {what}; "
              "tracing again", file=sys.stderr, flush=True)
    raise RuntimeError(f"torch.profiler lost the trace of {reps} calls of {what} "
                       f"{tries} times")


def library_index_add_fn(mosaic, count, tiles, rows, cols) -> Callable:
    """One ``index_add_`` computing the same sums and counts as
    ``blend_count`` (atomics, so not bit-stable) — a yardstick only; the
    port never calls it."""
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
