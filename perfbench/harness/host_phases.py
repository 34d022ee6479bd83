"""The serve loop's host phases, from the program's own scene records.

Each scene record of ``Predictor.scenes`` holds ``host_s``: the host
seconds of each of the serve loop's phases (``serve.read``,
``serve.stack``, ``serve.h2d``, ...), summed over the scene. A program
without those records gives no reading.
"""

from __future__ import annotations

from typing import Optional


def per_batch_ms(run, phase: str) -> Optional[float]:
    """Mean host milliseconds a batch in ``phase`` over the window's
    scenes: the phase's seconds summed over the scenes, over their batches;
    None where no scene records the phase."""
    scenes = [s for s in run.record.get("scenes", []) if phase in s.get("host_s", {})]
    batches = sum(s["batches"] for s in scenes)
    return 1e3 * sum(s["host_s"][phase] for s in scenes) / batches if batches else None
