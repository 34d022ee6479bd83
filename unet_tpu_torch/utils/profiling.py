"""Spans of work, and device traces of a run.

Counterpart of ``unet_tpu/utils/profiling.py``, and the port's one span
facility:

* ``StepTimer`` accumulates host wall time per named phase and reports
  count, total and percentiles. A phase always records its host seconds
  (two clock reads and an append); while a ``torch.profiler`` runs it is
  also a ``record_function`` range of its name, so the phases lie on the
  profiler's timeline beside the card's kernels. The serve loop's phases
  (``serve.*``, ``predict/predict.py``) and the trainer's
  (``<desc>_profile.txt``) are ``StepTimer`` phases.
* ``DeviceSpans``: the device time of spans of work, from a pair of CUDA
  events around each on the card (read once at the end), the host clock
  elsewhere: ``Predictor.forward_ms()``, ``Trainer.step_ms()``, the
  serve loop's ``finalize_s``.
* ``device_trace`` records a ``torch.profiler`` trace (the CPU, and the
  card when the run is on one) of the work in its block into a
  directory, as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

# the profiler's own enabled flag: a span makes a range only while it is set
_profiling = torch._C._autograd._profiler_enabled


class StepTimer:
    """Host wall-time samples per phase; a phase is a profiler range of
    its name while a profiler runs."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        mark = torch.profiler.record_function(name) if _profiling() else None
        if mark is not None:
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)
            if mark is not None:
                mark.__exit__(None, None, None)

    def totals(self) -> Dict[str, float]:
        """Host seconds of each phase, summed over its samples."""
        return {name: sum(xs) for name, xs in self.samples.items()}

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


class DeviceSpans:
    """Durations of timed spans of work: on the card a pair of CUDA events
    around each (device time, read once at the end, no wait in between),
    elsewhere the host clock. ``spans`` holds one entry a span."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.spans: List = []
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((self._t0, end))
        else:
            self.spans.append(time.perf_counter() - self._t0)

    def ms(self) -> List[float]:
        """Milliseconds of every span so far (waits for the card)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            return [s.elapsed_time(e) for s, e in self.spans]
        return [t * 1e3 for t in self.spans]


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
