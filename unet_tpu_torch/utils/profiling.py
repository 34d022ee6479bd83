"""Phase timing and device traces of a training run.

Counterpart of ``unet_tpu/utils/profiling.py``: ``StepTimer`` accumulates
host wall time per named phase (cheap enough to always run) and reports
count, total and percentiles; ``device_trace`` records a
``torch.profiler`` trace (the CPU, and the card when the run is on one)
of the work in its block into a directory, as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


class StepTimer:
    """Wall-time samples per phase."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
            }
        return out

    def report(self) -> str:
        rows = ["phase                 count   total_s   mean_ms    p50_ms    p95_ms"]
        for name, s in sorted(self.summary().items()):
            rows.append(
                f"{name:<20} {s['count']:>6} {s['total_s']:>9.2f} "
                f"{s['mean_ms']:>9.2f} {s['p50_ms']:>9.2f} {s['p95_ms']:>9.2f}"
            )
        return "\n".join(rows)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device: torch.device,
                 name: str = "trace") -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to
    ``<log_dir>/<name>.pt.trace.json`` (viewable in Perfetto or
    chrome://tracing); a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{name}.pt.trace.json"))
