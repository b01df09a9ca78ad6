"""The recognizer and gallery: one frame's top-1 against the gallery (the
queries' upload, K1, its download and the ids), the port's
``gallery.match`` spans that begin inside the traced interval, mean."""

from portbench import spans

LAYER = "recognizer + gallery"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    p = spans.traced(run)
    walls = [s.end_ns - s.start_ns for s in (p.spans if p else [])
             if s.name == "gallery.match" and spans.in_interval(p, s.start_ns)]
    return sum(walls) / len(walls) / 1e6 if walls else None
