"""The batcher: a frame's wait from ``MicroBatcher.submit`` to the drain
that takes it into a batch, the port's ``batcher.queue`` spans that end
inside the traced interval, mean."""

from portbench import spans

LAYER = "batcher"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    p = spans.traced(run)
    waits = [s.end_ns - s.start_ns for s in (p.spans if p else [])
             if s.name == "batcher.queue" and spans.in_interval(p, s.end_ns)]
    return sum(waits) / len(waits) / 1e6 if waits else None
