"""The facade (``models/zoo.py``): the host's preparation of a batch (BGR
to RGB, letterbox, stacking, the native-frame pad, the yuv420 encode), the
self time of the port's ``facade.prep`` spans a traced batch."""

from portbench import spans

LAYER = "facade"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return spans.self_ms_per_batch(run, ("facade.prep",))
