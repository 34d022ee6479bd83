"""What a traffic generator is handed, and the timing helpers it uses."""

from __future__ import annotations

import contextlib
import gc
import importlib
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import torch

from .trace import SPAN_PREFIX, Tracer


class Spans:
    """Host-clock spans by name, recorded from the benchmark's own files
    around the calls into each layer; inside a traced slice each is also a
    profiler span."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = (torch.profiler.record_function(SPAN_PREFIX + name) if self.tracer.active
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


class Marks:
    """Points on the device's timeline: a CUDA event recorded on the
    current stream on the card (read once at the end), the host clock on
    the CPU, where work is done when the call returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.points.append(e)
        else:
            self.points.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        """Milliseconds between consecutive marks (waits for the card)."""
        if self.cuda:
            self.points[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.points, self.points[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.points, self.points[1:])]


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32: TF32 off for cuDNN and matmuls."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    """Return the allocator's cached blocks after the program's state is
    dropped, before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_module(config: dict):
    """The plain reference a configuration names (``reference/<name>.py``)."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclass
class Context:
    """One run of one cell: the configuration and traffic mix as their
    files state them, the cell's own file (its limits and traced slice),
    the run's arguments, its device and a scratch directory under TMPDIR."""

    config: dict
    mix: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: Path
    t_start: float                      # host clock at process start
    tracer: Tracer = None
    spans: Spans = None
    record: dict = field(default_factory=dict)

    def __post_init__(self):
        plan = self.cell["trace"]
        self.tracer = Tracer(self.trace, self.device, self.seconds,
                             plan["after_frac"], plan["units"])
        self.spans = Spans(self.tracer)
