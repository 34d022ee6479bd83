"""``unet_tpu_torch doctor`` — is this machine ready to train and serve?

Counterpart of ``unet_tpu/utils/doctor.py``: each check runs isolated, so
one that raises is reported as FAIL and cannot take the others down, and
the report has the same format. The checks:

* ``versions`` — the port, torch, CUDA, numpy and Python;
* ``devices`` — the CUDA devices with their memory and compute
  capability, which must be 9.0: every kernel is built for ``sm_90a``
  only. Without a card the check fails with "no CUDA device", and nothing
  runs on the CPU instead;
* ``mesh`` — a one-process group on a free localhost port (NCCL on the
  card, gloo for ``device="cpu"``) all-reduces a tensor on the device and
  is torn down; inside a process group it reports that group instead;
* ``toolchain`` (the counterpart of the compile-cache check) — nvcc's path
  and version, and the kernel build directory with its cached libraries;
* ``native decoder`` — its ABI version, or the build error;
* ``optional deps`` — the optional modules, each found or MISSING with
  what it is for: PIL and tqdm (JAX's list without torch, which is core
  here) and matplotlib, seaborn and pandas, which draw the training and
  validation PNGs. A machine without them trains and predicts, and skips
  those PNGs with a line naming the module, so the check passes either
  way (JAX's fails, and its ``doctor`` exits 1, where one is missing);
* ``kernels`` (opt-in, as ``--pallas`` is) — ``ops.probe.capability_check``:
  every CUDA kernel built, launched once and compared with its plain
  version.

``versions``, ``devices`` and ``mesh`` are blocking.
"""

from __future__ import annotations

import platform
import subprocess
from typing import Callable, Dict, List, Tuple

CAPABILITY = (9, 0)  # sm_90a, the only target the kernels are built for


def _check(fn: Callable[[], Tuple[bool, str]]) -> Tuple[bool, str]:
    try:
        return fn()
    except Exception as e:  # diagnostics never crash
        return False, f"{type(e).__name__}: {e}"


def _versions() -> Tuple[bool, str]:
    import numpy as np
    import torch

    import unet_tpu_torch

    return True, (f"unet_tpu_torch {unet_tpu_torch.__version__}, torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}, numpy "
                  f"{np.__version__}, python {platform.python_version()}")


def _devices() -> Tuple[bool, str]:
    import torch

    if not torch.cuda.is_available():
        return False, ("no CUDA device (torch.cuda.is_available() is False): not "
                       "ready; nothing runs on the CPU instead")
    parts, ok = [], True
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        cap = (p.major, p.minor)
        ok &= cap == CAPABILITY
        parts.append(f"{i}: {p.name}, {p.total_memory / 2**30:.1f} GiB, compute "
                     f"capability {p.major}.{p.minor}"
                     + ("" if cap == CAPABILITY else " (the kernels need 9.0)"))
    return ok, f"{torch.cuda.device_count()} CUDA device(s): " + "; ".join(parts)


def _mesh(device: str = "cuda") -> Tuple[bool, str]:
    import torch
    import torch.distributed as dist

    from ..parallel import mesh

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return False, "no CUDA device: no data-parallel world to build"
    where = (f"{torch.cuda.device_count()} CUDA devices" if dev.type == "cuda"
             else "the CPU")
    own = not dist.is_initialized()
    if own:
        mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0, device=dev)
    try:
        t = torch.ones(4, device=mesh.rank_device(dev))
        dist.all_reduce(t)
        world = dist.get_world_size()
        if t.sum().item() != 4 * world:
            return False, f"all-reduce over {world} ranks gave {t.tolist()}"
        return True, (f"data-parallel world of {world} over {where}, backend "
                      f"{dist.get_backend()}")
    finally:
        if own:
            mesh.close_distributed()


def _toolchain() -> Tuple[bool, str]:
    from ..ops import _build

    nvcc = _build.nvcc_path()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    cached = len(list(_build.BUILD_DIR.glob("*.so"))) if _build.BUILD_DIR.is_dir() else 0
    return True, (f"{nvcc} ({out[-1] if out else 'version unknown'}); kernels build "
                  f"into {_build.BUILD_DIR} ({cached} libraries cached)")


def _native() -> Tuple[bool, str]:
    from .. import native

    if not native.available():
        return False, f"native decoder unavailable: {native.build_error()}"
    return True, (f"{native.library_path().name} ABI v"
                  f"{native.get_lib().unet_native_version()} (batch TIFF decode, "
                  "LZW/PackBits/deflate, JPEG incl. progressive)")


OPTIONAL_DEPS = (("PIL", "JPEG-in-TIFF fallback + codec cross-checks"),
                 ("tqdm", "per-tile progress bars"),
                 ("matplotlib", "training and validation PNGs"),
                 ("seaborn", "training and validation PNGs"),
                 ("pandas", "training and validation PNGs"))


def _optional_deps() -> Tuple[bool, str]:
    from .plots import missing_modules

    missing = set(missing_modules(*(mod for mod, _ in OPTIONAL_DEPS)))
    return True, ", ".join(f"{mod} MISSING ({why})" if mod in missing else mod
                           for mod, why in OPTIONAL_DEPS)


def _kernels() -> Tuple[bool, str]:
    from ..ops.probe import capability_check

    results = capability_check()
    return (all(ok for ok, _ in results.values()),
            "; ".join(f"{name} {'ok' if ok else 'FAIL'} ({detail})"
                      for name, (ok, detail) in results.items()))


def run_doctor(kernels: bool = False, device: str = "cuda") -> Dict[str, Tuple[bool, str]]:
    """Run every check; print a report; return {name: (ok, detail)}.

    ``kernels=True`` also builds and checks every CUDA kernel on the card
    (a few seconds of nvcc, hence opt-in). ``device`` is where the ``mesh``
    check builds its group (``cpu``: gloo on the CPU)."""
    checks: List[Tuple[str, Callable]] = [
        ("versions", _versions),
        ("devices", _devices),
        ("mesh", lambda: _mesh(device)),
        ("toolchain", _toolchain),
        ("native decoder", _native),
        ("optional deps", _optional_deps),
    ]
    if kernels:
        checks.append(("kernels", _kernels))
    results: Dict[str, Tuple[bool, str]] = {}
    for name, fn in checks:
        ok, detail = _check(fn)
        results[name] = (ok, detail)
        print(f"  {'ok ' if ok else 'FAIL'}  {name:<16} {detail}")
    hard = [n for n in ("versions", "devices", "mesh") if not results[n][0]]
    print("doctor: " + ("all checks passed" if all(ok for ok, _ in results.values())
                        else f"issues found{' (blocking: ' + ', '.join(hard) + ')' if hard else ''}"))
    return results
