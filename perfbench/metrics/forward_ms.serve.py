"""Median of the predictor's own span of a batch's forward,
``Predictor.forward_ms()`` (CUDA events around the forward and its
softmax), over the window's batches, milliseconds."""

import statistics


def read(run):
    ms = run.record.get("forward_ms")
    return statistics.median(ms) if ms else None
