"""The engine: a traced batch's blocking downloads (the wait for the card
to finish the batch's queued work, then the device-to-host copy), the self
time of the port's ``engine.wait`` spans."""

from portbench import spans

LAYER = "engine + models"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return spans.self_ms_per_batch(run, ("engine.wait",))
