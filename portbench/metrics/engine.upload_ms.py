"""The engine (``engine/pipeline.py``): the host-to-device copies of a
traced batch (pageable on the two-program path), the self time of the
port's ``engine.upload`` spans."""

from portbench import spans

LAYER = "engine + models"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return spans.self_ms_per_batch(run, ("engine.upload",))
