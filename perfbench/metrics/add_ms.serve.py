"""Mean host milliseconds a batch that the serve loop spends adding the
batch's probabilities into the mosaic (its offsets to the card, the
``blend_count`` launch): the program's span ``serve.add``, summed over the
window's scenes (``host_s`` of each scene record) over their batches."""

from perfbench.harness.host_phases import per_batch_ms


def read(run):
    return per_batch_ms(run, "serve.add")
