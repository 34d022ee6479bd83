"""ctypes bindings for the native tile decoder (``tiffdec.cpp``,
``jpegdec.cpp``).

Counterpart of ``unet_tpu/native``, with its own copy of the C++ sources
(ABI v4). At first use the sources build with g++ into
``_build/libunet_native-<hash>.so``, named by a hash of the sources, the
flags and the host CPU's feature flags: the library is compiled with
``-march=native`` and must not load on another CPU. The build writes a
temporary file and renames it into place, so processes that build at the
same time do not see each other's half-written library.

zlib is linked as the runtime library ``libz.so.1`` (``-l:libz.so.1``) and
its one function the decoder calls is declared in ``tiffdec.cpp``, so the
build needs neither zlib's headers nor the ``libz.so`` development link.

A failed build raises ``RuntimeError`` with g++'s stderr from
``get_lib``; ``available()`` then returns False and ``build_error()``
keeps the message for ``doctor``. The batch decoders raise without the
library; the byte codecs and ``jpeg_decode`` return None, and the TIFF
codec takes its Python path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_HERE = Path(__file__).parent
SOURCES = ("tiffdec.cpp", "jpegdec.cpp")
HEADERS = ("jpegdec.h",)
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
LINK_FLAGS = ["-l:libz.so.1", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_lock = threading.Lock()


def _cpu_features() -> str:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("flags", "Features")):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((_HERE / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(_cpu_features().encode())
    return BUILD_DIR / f"libunet_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the decoder unless its library exists (``force`` compiles it
    anyway); returns the path. Raises ``RuntimeError`` with g++'s stderr."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *(str(_HERE / s) for s in SOURCES), "-o", str(tmp),
           *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build the native decoder: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native decoder:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.unet_native_version.restype = ctypes.c_int
    lib.unet_decode_batch.restype = ctypes.c_int
    lib.unet_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.unet_decode_masks.restype = ctypes.c_int
    lib.unet_decode_masks.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.unet_decode_batch_raw.restype = ctypes.c_int
    lib.unet_decode_batch_raw.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    codec_sig = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
                 ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    for fn in ("unet_lzw_decode", "unet_lzw_encode",
               "unet_packbits_decode", "unet_packbits_encode"):
        getattr(lib, fn).restype = ctypes.c_longlong
        getattr(lib, fn).argtypes = codec_sig
    intp = ctypes.POINTER(ctypes.c_int)
    lib.unet_jpeg_info.restype = ctypes.c_int
    lib.unet_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, intp, intp, intp, intp, intp,
    ]
    lib.unet_jpeg_decode.restype = ctypes.c_int
    lib.unet_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        intp, intp, intp, ctypes.c_int,
    ]
    lib.unet_jpeg_decode16.restype = ctypes.c_int
    lib.unet_jpeg_decode16.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
        intp, intp, intp, intp,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use. Raises ``RuntimeError``
    with the build's error, then and on every later call."""
    global _lib, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise RuntimeError(_error)
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, AttributeError) as e:
                _error = str(e) if isinstance(e, RuntimeError) else f"{type(e).__name__}: {e}"
                raise RuntimeError(_error) from e
    return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except RuntimeError:
        return False


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    return _error


def _paths_array(paths: List) -> "ctypes.Array":
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def decode_batch(paths: List, height: int, width: int, channels: int,
                 n_threads: int = 8, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode equally-sized tiles into an (N,H,W,C) float32 batch in
    parallel native threads. Raises ``RuntimeError`` on failure."""
    lib = get_lib()
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, channels), np.float32)
    stride = height * width * channels
    rc = lib.unet_decode_batch(
        _paths_array(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), stride,
        height, width, channels, n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native decode failed on tile {rc - 1}: {paths[rc - 1]}")
    return out


def decode_batch_raw(paths: List, height: int, width: int, channels: int,
                     dtype: np.dtype, n_threads: int = 8,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode equally-sized tiles into an (N,H,W,C) batch in the files' own
    sample type, so 1 byte a pixel stays 1 byte through
    host RAM and the copy to the device. Raises ``RuntimeError`` on
    failure."""
    lib = get_lib()
    dt = np.dtype(dtype)
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, channels), dt)
    stride = height * width * channels * dt.itemsize
    rc = lib.unet_decode_batch_raw(
        _paths_array(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), stride,
        height, width, channels, dt.itemsize, int(dt.kind == "f"), n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native raw decode failed on tile {rc - 1}: {paths[rc - 1]}")
    return out


def decode_masks(paths: List, height: int, width: int,
                 n_threads: int = 8, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode equally-sized single-band tiles into an (N,H,W) int32 batch.
    Raises ``RuntimeError`` on failure."""
    lib = get_lib()
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width), np.int32)
    rc = lib.unet_decode_masks(
        _paths_array(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), height * width,
        height, width, n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native mask decode failed on tile {rc - 1}: {paths[rc - 1]}")
    return out


def _codec_call(fn_name: str, data: bytes, cap: int) -> Optional[bytes]:
    """Run one of the native byte codecs; None without the library or on
    failure."""
    if not available():
        return None
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        (ctypes.c_uint8 * 1)()
    dst = (ctypes.c_uint8 * max(cap, 1))()
    n = getattr(_lib, fn_name)(src, len(data), dst, cap)
    if n < 0:
        return None
    return bytes(bytearray(dst)[:n])


def lzw_decode(data: bytes, expected: int) -> Optional[bytes]:
    """Native TIFF-LZW decode (``expected`` = exact decoded size)."""
    out = _codec_call("unet_lzw_decode", data, expected)
    return out if out is not None and len(out) == expected else None


def lzw_encode(data: bytes) -> Optional[bytes]:
    return _codec_call("unet_lzw_encode", data, 2 * len(data) + 1024)


def packbits_decode(data: bytes, expected: int) -> Optional[bytes]:
    out = _codec_call("unet_packbits_decode", data, expected)
    return out if out is not None and len(out) == expected else None


def packbits_encode(data: bytes) -> Optional[bytes]:
    return _codec_call("unet_packbits_encode", data, 2 * len(data) + 1024)


def jpeg_decode(data: bytes, tables: Optional[bytes] = None,
                color_transform: Optional[bool] = None) -> Optional[np.ndarray]:
    """Native JPEG decode → (H, W, C) uint8 (baseline/progressive DCT) or
    uint8/uint16 (lossless SOF3, by frame precision); None without the
    library or when the stream needs the Python path (arithmetic, 12-bit
    DCT). Follows ``geo.jpeg.decode``; the TIFF codec tries this first."""
    if not available():
        return None
    lib = _lib
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    prec, mode = ctypes.c_int(), ctypes.c_int()
    if lib.unet_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c), ctypes.byref(prec),
                          ctypes.byref(mode)) != 0:
        return None
    if h.value <= 0 or w.value <= 0 or not 1 <= c.value <= 4:
        return None
    if h.value * w.value * c.value > 1 << 30:
        # a TIFF strip/tile segment is never GiB-scale decoded; a forged
        # frame header must not drive the allocation (decode scratch is
        # ~10x the output size)
        return None
    if mode.value == 2:  # lossless
        try:
            out16 = np.empty((h.value, w.value, c.value), np.uint16)
        except MemoryError:
            return None
        rc = lib.unet_jpeg_decode16(
            data, len(data), tables, len(tables) if tables else 0,
            out16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out16.size,
            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), ctypes.byref(prec),
        )
        if rc != 0:
            return None
        return out16.astype(np.uint8) if prec.value <= 8 else out16
    try:
        out = np.empty((h.value, w.value, c.value), np.uint8)
    except MemoryError:
        return None
    ct = -1 if color_transform is None else int(bool(color_transform))
    rc = lib.unet_jpeg_decode(
        data, len(data), tables, len(tables) if tables else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), ct,
    )
    if rc != 0:
        return None
    return out
