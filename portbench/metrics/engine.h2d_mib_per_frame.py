"""The engine (``engine/pipeline.py``): the bytes copied host to device for
the traced batches, over their frames, in MiB: the ``bytes`` that each of
their ``engine.upload`` spans carries."""

from portbench import spans

LAYER = "engine + models"
UNIT = "MiB/frame"
MOVES = "memory_peak_gib"


def read(run):
    p = spans.traced(run)
    bs = spans.batches(p) if p else []
    frames = sum(b.frames for b in bs)
    if not frames:
        return None
    moved = sum(s.attrs.get("bytes", 0) for b in bs for s in b.spans if s.name == "engine.upload")
    return moved / frames / 2**20
