"""The traced slice of a window, and what is read from it.

``Tracer`` runs ``torch.profiler`` (the card's kernels, copies and sets,
and the host's operations and the benchmark's spans) over a slice of the
measured window: from the first unit (a step, a scene) that starts past a
share of the window, for a fixed number of units, the card drained at
both ends. ``summary()`` reduces the trace to what the per-layer readers
take: the device time of each kernel by name, the union of the card's busy
intervals, the slice's length, the operations that took most time and the
longest idle gaps, each named by what the host was doing then.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "perfbench."
TOP = 10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    def __init__(self, enabled: bool, device: torch.device, seconds: float,
                 after_frac: float, units: int):
        self.enabled = enabled
        self.device = device
        self.after_s = seconds * after_frac
        self.units_planned = units
        self.units = 0          # units begun inside the slice
        self.before = (0, 0.0)  # (units, seconds) of the window before the slice
        self._seen = 0
        self._prof = None
        self._t0 = self._t1 = None
        self._results = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def warm(self) -> None:
        """Start and stop the profiler once around a trivial operation, so
        that the tracing library is set up before the window (the first
        start on a card takes seconds)."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            _sync(self.device)

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def boundary(self, elapsed_s: float) -> None:
        """Call before each unit of work, with the window's elapsed seconds."""
        if not self.enabled or self._results is not None:
            return
        if self._prof is None:
            if elapsed_s >= self.after_s:
                self.before = (self._seen, elapsed_s)
                self._start()
                self.units = 1
            self._seen += 1
            return
        if self.units >= self.units_planned:
            self._stop()
        else:
            self.units += 1

    def finish(self) -> None:
        """At the window's end: close a slice still open."""
        if self._prof is not None:
            self._stop()

    def _start(self) -> None:
        _sync(self.device)
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _stop(self) -> None:
        _sync(self.device)
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self._results = self._prof.profiler.kineto_results  # read after the window
        self._prof = None

    def _events(self) -> List[Tuple[str, bool, int, int]]:
        """(name, on the device, start ns, end ns) of every traced event;
        the device's copies of the benchmark's spans (user annotations)
        are not device work and are left out."""
        out = []
        for e in self._results.events():
            on_dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if on_dev and (e.name().startswith(SPAN_PREFIX)
                           or getattr(e, "is_user_annotation", lambda: False)()):
                continue
            out.append((e.name(), on_dev, e.start_ns(), e.start_ns() + e.duration_ns()))
        return out

    def summary(self) -> Optional[dict]:
        """None when nothing was traced; else {"window_s", "busy_s",
        "units", "before_units", "before_s" (the units begun in the window
        before the slice, and the seconds they took), "kernels": {name:
        [count, seconds]}, "device_ops", "idle_gaps"}."""
        if self._results is None:
            return None
        events = self._events()
        dev = sorted((s, e, n) for n, on_dev, s, e in events if on_dev)
        host = [(s, e, n) for n, on_dev, s, e in events if not on_dev]
        kernels: Dict[str, List[float]] = {}
        for s, e, n in dev:
            k = kernels.setdefault(n, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e9
        busy, end, gaps = 0.0, None, []
        for s, e, _ in dev:
            if end is not None and s > end:
                gaps.append((end, s))
            if end is None or e > end:
                busy += (e - max(s, end)) / 1e9 if end is not None else (e - s) / 1e9
                end = e
        top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        return {
            "window_s": self._t1 - self._t0,
            "busy_s": busy,
            "units": self.units,
            "before_units": self.before[0],
            "before_s": self.before[1],
            "kernels": kernels,
            "device_ops": [[n[:160], v[1]] for n, v in top_ops],
            "idle_gaps": [[_host_doing(host, g), (g[1] - g[0]) / 1e9] for g in longest],
        }


def _host_doing(host: List[Tuple[int, int, str]], gap: Tuple[int, int]) -> str:
    """What the host was doing in the middle of an idle gap: the innermost
    benchmark span and the outermost operation of the program then."""
    mid = (gap[0] + gap[1]) // 2
    span, op = None, None
    for s, e, n in host:
        if not s <= mid < e:
            continue
        if n.startswith(SPAN_PREFIX):
            if span is None or s > span[0]:
                span = (s, n[len(SPAN_PREFIX):])
        elif not n.startswith(("cuda", "cu")) and (op is None or s < op[0]):
            op = (s, n)
    return f"{span[1] if span else 'window'}: {op[1] if op else 'python'}"[:160]
