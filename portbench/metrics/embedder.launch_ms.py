"""The embedder's launch: the Python that queues a traced batch's embedder
forward (its layers' launches; the ViT's attention-backend pin), the self
time of the port's ``engine.embedder`` spans, a batch.  ``engine.launch_ms``
leaves this time out since the span exists.  Nothing to read from a port
that records no ``engine.embedder`` span."""

from portbench import spans

LAYER = "engine + models"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    p = spans.traced(run)
    if p is None or not any(s.name == "engine.embedder" for s in p.spans):
        return None
    return spans.self_ms_per_batch(run, ("engine.embedder",))
