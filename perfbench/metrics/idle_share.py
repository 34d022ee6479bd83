"""Share of the traced slice of the window in which the card ran no
kernel, copy or set (one minus the union of the traced device intervals
over the slice's length), percent."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
