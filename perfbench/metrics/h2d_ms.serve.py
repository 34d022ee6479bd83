"""Mean host milliseconds a batch that the serve loop spends making the
batch contiguous, pinning it and queueing its copy to the card: the
program's span ``serve.h2d``, summed over the window's scenes (``host_s``
of each scene record) over their batches."""

from perfbench.harness.host_phases import per_batch_ms


def read(run):
    return per_batch_ms(run, "serve.h2d")
