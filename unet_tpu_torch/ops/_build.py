"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, named by a
hash of the source and the flags so that an edit rebuilds it. The library
exposes plain C launchers that take device pointers and a CUDA stream
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``).
``torch.utils.cpp_extension.load`` is not used: it needs ninja and takes
minutes to compile PyTorch's headers. A failed build raises with nvcc's
stderr; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, ``PATH`` or /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.h")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, force: bool = False, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists (``force``
    compiles it anyway); returns the path. ``verbose`` prints ptxas'
    register and shared-memory report when it compiles."""
    out = library_path(name)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib
