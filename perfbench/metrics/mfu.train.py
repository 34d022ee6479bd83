"""The training step's share of the card's bf16 peak: three times the
forward FLOPs of a tile (the reference model's convolutions and matrix
products, counted once: recomputation is not counted) times the tiles a
second of the traced run's window before its traced slice (all steps over
all that time; the profiler slows the slice), over 989 TFLOP/s (H100 SXM,
dense), percent."""

from perfbench.harness.yardstick import BF16_FLOPS_PER_S
from perfbench.reference.work import forward_flops


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0 or not t["before_units"]:
        return None
    rate = t["before_units"] * run.record["batch"] / t["before_s"]
    return 100.0 * 3 * forward_flops(run.config, run.record["tile"]) * rate / BF16_FLOPS_PER_S
