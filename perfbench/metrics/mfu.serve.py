"""The serve loop's share of the card's bf16 peak: the forward FLOPs of a
window (the reference model's convolutions and matrix products) times the
scene windows served a second in the traced run's window before its traced
slice (whole scenes over all that time; the profiler slows the slice),
over 989 TFLOP/s (H100 SXM, dense), percent. Padding windows of a scene's
last batch are not counted."""

from perfbench.harness.yardstick import BF16_FLOPS_PER_S, windows
from perfbench.reference.work import forward_flops


def read(run):
    t, r = run.trace, run.record
    if t is None or t["busy_s"] <= 0 or not t["before_units"]:
        return None
    per_scene = len(windows(r["scene"], r["scene"], r["patch"], r["overlap"]))
    rate = t["before_units"] * per_scene / t["before_s"]
    return 100.0 * forward_flops(run.config, r["patch"]) * rate / BF16_FLOPS_PER_S
