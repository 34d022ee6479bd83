"""Share of their bound that the ``bn_stats`` kernels reach in the traced
steps: the least time of every BatchNorm site's forward sums
(``bn_sum_sumsq``) and backward sums (``bn_bwd_sums``) of a step, counted
from the reference model's BatchNorm input shapes at the cell's batch and
tile in the configuration's dtype, times the steps traced, over the device
time of the two kernels' launches (their per-channel partial and finish
kernels, by name) in the trace, percent."""

import re

from perfbench.harness.yardstick import bn_work, bound_s
from perfbench.reference.work import bn_sites

KERNELS = re.compile(r"\bpartial_kernel<|\bfinish_kernel\b")
ELEMENT_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    trace = run.trace
    if trace is None:
        return None
    device_s = sum(s for name, (_, s) in trace["kernels"].items() if KERNELS.search(name))
    if device_s <= 0:
        return None
    size = ELEMENT_SIZE[run.config["dtype"]]
    step_s = sum(bound_s(*bn_work(shape, size, False)) + bound_s(*bn_work(shape, size, True))
                 for shape in bn_sites(run.config, run.record["batch"], run.record["tile"]))
    return 100.0 * step_s * trace["units"] / device_s
