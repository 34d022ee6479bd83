"""Share of its bound that the ``flip_scale`` kernel reaches in the traced
steps: the least time of one launch a step over the batch of uint8 tiles
and uint8 masks (images read and written as float32, masks read and
written), times the steps traced, over the kernel's device time in the
trace, percent."""

from perfbench.harness.yardstick import bound_s, flip_work


def read(run):
    trace = run.trace
    if trace is None:
        return None
    device_s = sum(s for name, (_, s) in trace["kernels"].items() if "flip_scale_kernel" in name)
    if device_s <= 0:
        return None
    r = run.record
    step_s = bound_s(*flip_work(r["batch"], run.config["bands"], r["tile"], r["tile"], 1, 1))
    return 100.0 * step_s * trace["units"] / device_s
