"""Capability check of the port's CUDA kernels, and the offset-copy kernel.

Counterpart of ``unet_tpu/ops/probe.py``. There a minimal Pallas kernel
(a DMA at a scalar-prefetched offset) probes whether the TPU toolchain
compiles the feature the other kernels need, and the verdict, cached on
disk, switches those kernels on or off.

* ``offset_copy(src, off)`` — binding of the CUDA kernel
  ``csrc/offset_copy.cu``, the counterpart of the probe's kernel:
  ``src[off*8 : off*8+8]`` of an (R, 128) float32 array, with the int32[1]
  offset read on the device and the rows moved by one bulk async copy
  into shared memory that completes through an mbarrier (and out by a
  second bulk copy); a bad offset comes back through a word of pinned
  host memory, so a call is one device operation. CUDA tensors
  only; anything else raises. Launches are counted in
  ``offset_copy.launches``.
* ``offset_copy_reference(src, off)`` — its plain version.
* ``capability_check(device)`` — the counterpart of
  ``scalar_prefetch_dma_supported`` and ``describe``: it builds every CUDA
  kernel of the port, launches each once at small shapes, and compares it
  with its plain version. It returns ``{kernel: (ok, detail)}``; a kernel
  that fails to build, launch or agree reports ``ok=False`` with nvcc's or
  CUDA's message.

The check is not a gate. It switches nothing, caches no verdict and reads
no environment variable: on the card the kernel is the path, and the
plain versions are for the CPU and for tests. So ``record_kernel_ab``,
``fused_aug_enabled`` and ``blend_kernel_enabled`` have no counterpart.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import threading
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

ROWS, COLS = 8, 128  # the rows one offset selects, and the row width
BN_REL_TOL = 1e-6  # bn_stats sums against float64, relative to Σ|·| (PERF.md §2)


def _check_offset(o: int, n_rows: int) -> None:
    if o < 0 or o * ROWS + ROWS > n_rows:
        raise ValueError(f"offset_copy: offset {o} out of range for {n_rows} rows "
                         f"(need 0 <= off and off*{ROWS} + {ROWS} <= {n_rows})")


def offset_copy_reference(src: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Plain version of ``offset_copy``: ``src[o*8 : o*8+8]`` as a new
    tensor, ``o = int(off[0])``; raises ``ValueError`` on the same bad
    offsets."""
    o = int(off[0])
    _check_offset(o, src.shape[0])
    return src[o * ROWS:o * ROWS + ROWS].clone()


_kernels: Dict[str, Callable] = {}


def _kernel(name: str) -> Callable:
    if not _kernels:
        from . import _build

        lib = _build.load("offset_copy")
        copy, empty = lib.offset_copy_launch, lib.offset_copy_empty_launch
        copy.restype = empty.restype = ctypes.c_int
        copy.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        empty.argtypes = [ctypes.c_void_p]
        _kernels.update(copy=copy, empty=empty)
    return _kernels[name]


_local = threading.local()  # this thread's pinned status word, made at its first call


def _status_word() -> torch.Tensor:
    """This thread's word of pinned host memory for the kernel's status (a
    call waits for its kernel before it returns, so one word a thread
    serves every device)."""
    if not hasattr(_local, "status"):
        _local.status = torch.empty(1, dtype=torch.int32, pin_memory=True)
    return _local.status


def _run_with_status(launch: Callable[[int], int], wait: Callable[[], None],
                     status: torch.Tensor) -> int:
    """Clear the host status word to 0, call ``launch`` with its address
    (it returns a CUDA error code), ``wait`` for the kernel, and return the
    word: still 0 unless the kernel refused the offset."""
    status.zero_()
    err = launch(status.data_ptr())
    if err != 0:
        raise RuntimeError(f"offset_copy launch failed: CUDA error {err}")
    wait()
    return int(status.item())


def _raise_for_status(word: int, off: torch.Tensor, n_rows: int) -> None:
    """0: the rows were copied. 1: the kernel refused the offset; it is read
    from the device (only now) for ``ValueError``'s message. Any other word
    is not the kernel's."""
    if word == 0:
        return
    if word == 1:
        o = int(off[0])
        _check_offset(o, n_rows)
        raise ValueError(f"offset_copy: the kernel refused offset {o} for {n_rows} rows")
    raise RuntimeError(f"offset_copy: status word {word} after the kernel")


def offset_copy(src: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel ``offset_copy``: ``src[off*8 : off*8+8]`` as a new
    (8, 128) float32 tensor, in one launch on the current stream.

    src (R, 128) float32 with R >= 8, contiguous and 16-byte aligned; off
    (1,) int32 on the same CUDA device. The kernel reads the offset on the
    device and marks a bad one in a word of pinned host memory; the
    wrapper waits on the stream and reads the word (no device-to-host
    copy), and raises ``ValueError`` when the offset is out of range
    (nothing is copied then). A failed launch raises ``RuntimeError``, and
    a fault in the kernel the stream's wait."""
    op = "offset_copy"
    for name, t in (("src", src), ("off", off)):
        if not t.is_cuda:
            raise ValueError(f"{op}: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if off.device != src.device:
        raise ValueError(f"{op}: tensors on different devices")
    if src.dtype != torch.float32 or src.dim() != 2 or src.shape[1] != COLS \
            or src.shape[0] < ROWS:
        raise ValueError(f"{op}: need an (R >= {ROWS}, {COLS}) float32 src, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if off.dtype != torch.int32 or off.shape != (1,):
        raise ValueError(f"{op}: off must be (1,) int32, got {tuple(off.shape)} {off.dtype}")
    out = torch.empty((ROWS, COLS), dtype=torch.float32, device=src.device)
    for name, t in (("src", src), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned (a bulk copy needs it)")
    status = _status_word()
    fn = _kernel("copy")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream()
        word = _run_with_status(
            lambda ptr: fn(src.data_ptr(), off.data_ptr(), out.data_ptr(), ptr,
                           src.shape[0], stream.cuda_stream),
            stream.synchronize, status)
    offset_copy.launches += 1
    _raise_for_status(word, off, src.shape[0])
    return out


offset_copy.launches = 0


def empty_kernel(device="cuda") -> None:
    """Launch a kernel that does nothing on the current stream of
    ``device``: the yardstick of launch latency, which bounds
    ``offset_copy``."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        err = _kernel("empty")(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


# --- the capability check ----------------------------------------------------


def _one_call_us(fn: Callable):
    """(result, microseconds) of one call of ``fn``, by CUDA events."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e) * 1e3


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _check_blend(dev: torch.device):
    from .blend import blend_and_count, blend_and_count_reference

    rng = np.random.default_rng(0)
    n, c, h, w, th, tw = 6, 3, 70, 90, 32, 40
    rows = rng.integers(0, h - th + 1, n)
    cols = rng.integers(0, w - tw + 1, n)
    g = torch.Generator(device=dev).manual_seed(0)
    tiles = torch.rand((n, c, th, tw), generator=g, device=dev)
    mk, ck = torch.rand((c, h, w), generator=g, device=dev), torch.zeros((h, w), device=dev)
    mp, cp = mk.clone(), ck.clone()
    _, us = _one_call_us(lambda: blend_and_count(mk, ck, tiles, rows, cols))
    blend_and_count_reference(mp, cp, tiles, rows, cols)
    equal = torch.equal(mk, mp) and torch.equal(ck, cp)
    return equal, max(_max_abs(mk, mp), _max_abs(ck, cp)), us, "bit-equal"


def _bn_inputs(dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4, 8, 12, 12), generator=g, device=dev) * 2 + 0.5
    dy = torch.randn((4, 8, 12, 12), generator=g, device=dev)
    return x, dy


def _within_f64(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> bool:
    return bool(((got.double() - want).abs() <= BN_REL_TOL * scale).all())


def _check_bn_fwd(dev: torch.device):
    from .bn import bn_sum_sumsq, bn_sum_sumsq_reference

    x, _ = _bn_inputs(dev)
    got, us = _one_call_us(lambda: bn_sum_sumsq(x))
    x64, dims = x.double(), (0, 2, 3)
    ok = (_within_f64(got[0], x64.sum(dims), x64.abs().sum(dims))
          and _within_f64(got[1], (x64 * x64).sum(dims), (x64 * x64).sum(dims)))
    return ok, _max_abs(got, bn_sum_sumsq_reference(x)), us, "within 1e-6 of float64"


def _check_bn_bwd(dev: torch.device):
    from .bn import bn_bwd_sums, bn_bwd_sums_reference

    x, dy = _bn_inputs(dev)
    mean = x.mean((0, 2, 3))
    inv = torch.rsqrt(x.var((0, 2, 3), unbiased=False) + 1e-5)
    got, us = _one_call_us(lambda: bn_bwd_sums(dy, x, mean, inv))
    dims = (0, 2, 3)
    dy64 = dy.double()
    xhat = (x.double() - mean.double().view(1, -1, 1, 1)) * inv.double().view(1, -1, 1, 1)
    ok = (_within_f64(got[0], dy64.sum(dims), dy64.abs().sum(dims))
          and _within_f64(got[1], (dy64 * xhat).sum(dims), (dy64 * xhat).abs().sum(dims)))
    return (ok, _max_abs(got, bn_bwd_sums_reference(dy, x, mean, inv)), us,
            "within 1e-6 of float64")


def _check_flip(dev: torch.device):
    from .aug import fused_flip_scale, fused_flip_scale_reference

    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.randint(0, 256, (4, 3, 16, 24), generator=g, device=dev, dtype=torch.uint8)
    msk = torch.randint(0, 3, (4, 16, 24), generator=g, device=dev, dtype=torch.uint8)
    hf = torch.tensor([False, True, False, True])
    vf = torch.tensor([False, False, True, True])
    scales = torch.tensor([1 / 255, 0.5, 1.0, 2.0])
    (ki, km), us = _one_call_us(lambda: fused_flip_scale(img, msk, hf, vf, scales))
    pi, pm = fused_flip_scale_reference(img, msk, hf, vf, scales)
    equal = torch.equal(ki, pi) and torch.equal(km, pm)
    return equal, max(_max_abs(ki, pi), _max_abs(km, pm)), us, "bit-equal"


def _check_offset_copy(dev: torch.device):
    src = torch.arange(2 * ROWS * COLS, dtype=torch.float32, device=dev).view(2 * ROWS, COLS)
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    got, us = _one_call_us(lambda: offset_copy(src, off))
    want = offset_copy_reference(src, off)
    return torch.equal(got, want), _max_abs(got, want), us, "bit-equal"


# kernel -> (source under csrc/, check)
CHECKS: Dict[str, Tuple[str, Callable]] = {
    "blend_count": ("blend_count", _check_blend),
    "bn_sum_sumsq": ("bn_stats", _check_bn_fwd),
    "bn_bwd_sums": ("bn_stats", _check_bn_bwd),
    "flip_scale": ("flip_scale", _check_flip),
    "offset_copy": ("offset_copy", _check_offset_copy),
}
SOURCES = tuple(dict.fromkeys(src for src, _ in CHECKS.values()))  # kernel sources


def capability_check(device="cuda") -> Dict[str, Tuple[bool, str]]:
    """Build every CUDA kernel of the port (one nvcc per source, in
    parallel), launch each once at small shapes, and compare it with its
    plain version: bit-equal for ``blend_count``, ``flip_scale`` and
    ``offset_copy``; the ``bn_stats`` sums within 1e-6 of float64 relative
    to Σ|·|. Returns ``{kernel: (ok, detail)}`` with the maximum error
    against the plain version and the microseconds of the one call (CUDA
    events; the first launch, so module loading is included).

    Raises ``RuntimeError`` without a CUDA device, and for ``device="cpu"``:
    the plain versions never stand in for the kernels."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"capability_check needs a CUDA device, got {dev}; "
                           "the plain versions are not a check of the kernels")
    from . import _build

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        builds = {src: pool.submit(_build.build, src) for src in SOURCES}
    build_errors = {src: f.exception() for src, f in builds.items() if f.exception()}
    results: Dict[str, Tuple[bool, str]] = {}
    for name, (src, check) in CHECKS.items():
        if src in build_errors:
            results[name] = (False, f"build failed: {build_errors[src]}")
            continue
        try:
            with torch.cuda.device(dev):
                ok, err, us, want = check(dev)
            verdict = want if ok else f"NOT {want}"
            results[name] = (ok, f"{verdict}, max |kernel - plain| {err:.3g}, "
                                 f"{us:.1f} us")
        except Exception as e:  # a launch or device fault is the check's answer
            results[name] = (False, f"{type(e).__name__}: {e}")
    return results
