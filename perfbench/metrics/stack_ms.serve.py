"""Mean host milliseconds a batch that the serve loop spends stacking the
batch's windows and padding the last batch: the program's span
``serve.stack``, summed over the window's scenes (``host_s`` of each scene
record) over their batches."""

from perfbench.harness.host_phases import per_batch_ms


def read(run):
    return per_batch_ms(run, "serve.stack")
