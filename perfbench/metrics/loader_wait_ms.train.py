"""Mean host time a step waits in ``next()`` on the trainer's tile loader
(a span of the benchmark's own, around the call), milliseconds."""


def read(run):
    waits = run.spans.get("loader_next")
    return 1e3 * sum(waits) / len(waits) if waits else None
