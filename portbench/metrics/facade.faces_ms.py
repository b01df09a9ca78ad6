"""The facade (``models/zoo.py``): the ``Face`` objects, the per-frame
lists and the embeddings and attributes attached to them, the self time of
the port's ``facade.faces`` spans a traced batch."""

from portbench import spans

LAYER = "facade"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return spans.self_ms_per_batch(run, ("facade.faces",))
