"""The recognizer and gallery, a frame: the harness's span around each
``match_faces`` call (the top-1 kernel, its download, the decisions), the
mean over the frames answered in the window."""

LAYER = "recognizer + gallery"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return sum(run.match_s) / len(run.match_s) * 1e3 if run.match_s else None
