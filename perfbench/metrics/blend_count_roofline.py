"""Share of its bound that the ``blend_count`` kernel reaches in the traced
scenes: the least time of each launch of a scene (one a batch of windows,
in the windows' order: each window's float32 probabilities read once, the
covered mosaic sums and counts read and written once), times the scenes
traced, over the kernel's device time in the trace, percent."""

from perfbench.harness.yardstick import blend_work, bound_s, windows


def read(run):
    trace = run.trace
    if trace is None:
        return None
    device_s = sum(s for name, (_, s) in trace["kernels"].items() if "blend_count_kernel" in name)
    if device_s <= 0:
        return None
    r = run.record
    offsets = windows(r["scene"], r["scene"], r["patch"], r["overlap"])
    scene_s = 0.0
    for i in range(0, len(offsets), r["batch"]):
        chunk = offsets[i:i + r["batch"]]
        scene_s += bound_s(*blend_work(len(chunk), run.config["classes"], r["patch"], r["patch"],
                                       [y for y, _ in chunk], [x for _, x in chunk]))
    return 100.0 * scene_s * trace["units"] / device_s
