"""Median of the trainer's own span of a step, ``Trainer.step_ms()``:
CUDA events from the batch's copy to the card to Adam's update,
milliseconds."""

import statistics


def read(run):
    ms = run.record.get("step_ms")
    return statistics.median(ms) if ms else None
